"""Smoke test of the PyTorch/CUDA port (``transcar_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

``--parent-csrc DIR`` also builds an earlier commit's kernel sources (for
example ``git archive <commit> transcar_tpu_torch/csrc`` unpacked under
the git-ignored ``transcar_tpu_torch/build/``) and times its K3 and K4 in
turns with these (parent, kernel, kernel, parent) in phases 4 and 8.

Phases, one line each (a failing phase raises and the script exits
non-zero):

  1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from ``transcar_tpu_torch/csrc`` (seconds taken);
  3. K1 (DCNv2 forward) against its plain version at both flagship DCN
     shapes, bfloat16 and float32, offsets drawn over ±8 px;
  4. K3 (DCNv2 backward) against autograd of its plain version at both
     flagship DCN shapes, bfloat16 and float32, offsets over ±8 px, zero
     and whole-pixel, and in bfloat16 at the model's offset scale; its two
     device kernels, (a) d_x + d_om and (b) d_W, timed apart;
  5. K2 (masked attention core) against its plain version at 900 × 1500,
     8 heads of 32, beside ``F.scaled_dot_product_attention``;
  6. the flagship slice through ``transcar_tpu_torch.cli.benchmark``:
     TransCAR-R101 batch-1 inference on 6 × 928 × 1600 with 900 queries
     and 1500 radar tokens, seeded random weights; launch counts, finite
     outputs, kernel path against plain path in float32 (one decoder
     layer, see phase_slice), samples/s of the kernel and the plain path
     in bfloat16;
  7. training through ``benchmark --train`` at the same width: the
     ``detr3d_r101`` full-backbone recipe (K1 forward, K3 backward) and
     the ``transcar_r101`` fusion-only recipe (K1 only), bfloat16
     backbone; finite losses, launch counts per step, which parameters
     moved, peak memory, ms/step; then one float32 step of each recipe,
     kernel path against plain path (see phase_train_check);
  8. K4 (OSA concat-reduce), K5 (whole OSA block) and K6 (fused
     bottleneck) against their plain versions at every distinct flagship
     shape (the 7 VoVNet-99 block shapes, the 3 R101 stride-1 non-DCN
     bottleneck shapes), bfloat16 and float32; K4 beside a cuDNN 1×1
     ``F.conv2d`` over the concatenation built beforehand, every bfloat16
     call on the Hopper (wgmma) tile and every float32 one on the wmma
     tile of ``conv_tile.cuh``;
  9. the VoVNet-99 slice through ``benchmark transcar_vovnet_trainval``:
     16 K4 + 3 K2 + 0 K1 launches per request, every K4 launch on the
     wgmma tile, finite outputs and decode,
     float32 kernel path against plain path (one decoder layer),
     samples/s and peak memory of the kernel and the plain path in
     bfloat16;
 10. the K5 path: the full-width VoVNet-99 backbone with
     ``stage_impls=("fused",) * 4`` (16 K5 launches) against the K4
     default on the 4 stage outputs, float32, and both timed in bfloat16;
 11. the K6 path: ``benchmark transcar_r101 --cfg-options
     model.backbone.block_impl=fused``: 6 K6 + 26 K1 + 3 K2 per request,
     float32 against the plain path, samples/s beside the default path;
 12. one ``transcar_vovnet_trainval --train`` fusion-only run: finite
     loss, camera frozen, no kernel launches (training takes the plain
     OSA tail, as in JAX), ms/step and peak memory;
 13. K7 (multi-scale deformable attention) against its plain version at
     the ObjDGCNN pillar shapes: one encoder call (87 040 queries over the
     256² / 128² / 64² / 32² BEV levels) and one decoder call (300
     queries), 8 heads of 32, 4 levels × 4 points, offsets up to ±48
     cells (far past any TPU band, and off the map), softmaxed weights;
 14. the ObjDGCNN pillar slice through ``benchmark objdgcnn_pillar``:
     300 000 points, 512² BEV, bfloat16 SECOND and FPN, float32 head, 300
     queries; 8 K7 launches per request and no other kernel, finite
     outputs and decode, samples/s and peak memory, then float32 with one
     decoder layer, kernel path against plain path;
 15. K8 (d_attn, d_loc) and K9 (d_value), the MSDeformAttn backward,
     against the plain backward (autograd of K7's plain version, chunked)
     at one encoder and one decoder call of the pillar shapes, with K7's
     inputs and a random output gradient;
 16. ``objdgcnn_pillar`` training through ``benchmark --train`` at the
     same width (dropout 0.1, batch statistics, clip 35, AdamW with the
     VFE and SECOND at lr × 0.1): 8 K7 + 8 K8 + 8 K9 launches per step
     and no other kernel, finite losses, trainable elements and BN running
     statistics moved, ms/step and peak memory; then one float32 step
     with one decoder layer and dropout 0, kernel path against plain path
     (gradients per leaf);
 17. no host sync: one warm batch-1 serving request of ``transcar_r101``
     and of ``transcar_vovnet_trainval`` under
     ``torch.cuda.set_sync_debug_mode("error")``, after a positive control
     (a pageable host-to-device copy must raise), and the same reported
     for ``objdgcnn_pillar``.

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  There is no CPU path: without CUDA the
script raises.
"""
from __future__ import annotations

import ctypes
import json
import math
import pathlib
import re
import subprocess
import time

import torch

FLAGSHIP_DCN = (  # (N, H, W, Cin, Cout, launches per request)
    (6, 58, 100, 256, 256, 23),
    (6, 29, 50, 512, 512, 3),
)
# max|kernel − plain| over max|plain|: one output rounding in bfloat16
# (2⁻⁸) with margin; float32 differs only by summation order over K ≤ 4608
DCN_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# K3 against autograd of the plain version, max|kernel − plain| over
# max|plain| per output: the plain version rounds d_samp and each of its
# four corner scatters to bfloat16 and the kernel accumulates in float32
# (a few bf16 ulps); in float32 the two differ by summation order, and
# the d_x / d_W atomics change that order from run to run
DCN_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the spread of the "model" K3 offsets, px (see dcn_backward_case)
MODEL_OFFSET_PX = 2.0
# Published dense peaks of one H100 SXM at 700 W (FLOP/s) and its memory
# rate (bytes/s), for the bound of each kernel's work
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
ATTN_TOL = 2e-4          # as tests/test_pallas_attention.py
SLICE_TOL = 1e-3         # float32 slice, kernel path vs plain path
# VoVNet-99 OSA blocks on 6 × 928 × 1600 (stem → 232 × 400):
# (H, W, C0, Ch, Cout, launches per request); 5 chain convs each
VOV_BLOCKS = (
    (232, 400, 128, 128, 256, 1),
    (116, 200, 256, 160, 512, 1),
    (116, 200, 512, 160, 512, 2),
    (58, 100, 512, 192, 768, 1),
    (58, 100, 768, 192, 768, 8),
    (29, 50, 768, 224, 1024, 1),
    (29, 50, 1024, 224, 1024, 2),
)
# R101 stride-1 non-DCN bottlenecks (layer1_0, layer1_1..2, layer2_1..3):
# (H, W, Cin, Cm, Cout, downsample, launches per request)
R101_K6 = (
    (232, 400, 64, 64, 256, True, 1),
    (232, 400, 256, 64, 256, False, 2),
    (116, 200, 512, 128, 512, False, 3),
)
# K4 / K5 / K6 against their plain versions, max|kernel − plain| over
# max|plain|: float32 by summation order; bfloat16 by that order before
# one output rounding (K4), or before the rounding of each chain output,
# where a value on a rounding boundary may go either way and carry into
# the next conv (K5, K6).  The channel sums are float32 values meeting
# in atomics in an order that changes from run to run.
CONV_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
CHAIN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
SUMS_TOL = 1e-4
# the K5 path against the K4 path over 16 float32 blocks: the two differ
# by summation order in every conv and reduce, compounded block by block
BACKBONE_TOL = 1e-3
# float32 train step, kernel path vs plain path: loss and gradient norm
# differ by summation order (the d_x / d_W atomics, the DCN GEMMs); the
# parameters after one AdamW step agree to 1e-2·lr in all but a few
# elements whose gradient is at rounding noise, where Adam's g / (|g| +
# eps) may step either way: those stay within 2·lr
STEP_TOL = 1e-4
PARAM_TIGHT, PARAM_SHARE = 1e-2, 0.999
# ObjDGCNN pillar BEV levels (512² canvas, SECOND strides 2/2/2, the
# extra level pooled): S = 87 040 tokens; 8 heads of 32, 4 points
BEV_LEVELS = ((256, 256), (128, 128), (64, 64), (32, 32))
# K7 against its plain version, max|kernel − plain| over max|plain|: both
# float32, differing by summation order over the 16 samples
MSDEFORM_TOL = 1e-5
# K8 / K9 against the plain backward, max|kernel − plain| over max|plain|
# per gradient: both float32, differing by summation order over the head's
# channels (d_attn, d_loc) and over the samples that reach one value cell
# (d_value, whose atomics add in an order that changes from run to run)
MSDEFORM_BWD_TOL = 1e-5
# the float32 pillar step, kernel path against plain path, per leaf
# max|Δ grad| over max|plain grad|: the kernels and the plain version
# differ by summation order (~1e-7 relative) in each deformable attention;
# the next layer's sampling locations move by that much, and a sample
# that crosses a cell edge switches its bilinear derivative, so a few of
# the millions of samples carry other d_loc terms into the gradients
PILLAR_GRAD_TOL = 1e-3


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(flops: float, dtype, moved_bytes: int) -> tuple:
    """The least time the card could take: the larger of the operations
    over the peak rate for their type and the bytes over the memory rate.
    Returns (ms, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = moved_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def dcn_bound_ms(x, om, wt, out_or_dout, backward: bool = False) -> float:
    """Bound of one DCN forward (out = K1(x, om, w)) or backward (d_x,
    d_om, d_W from x, om, w, d_out): the 9·Cin → Cout GEMM, twice in the
    backward, over each input read once and each output written once."""
    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    flops = 2.0 * n * h * w * 9 * cin * cout * (2 if backward else 1)
    moved = nbytes(x, om, wt, out_or_dout)
    if backward:            # outputs d_x, d_om (their dtypes) and d_W
        moved += nbytes(x, om, wt)
    return bound_ms(flops, x.dtype, moved)[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU: "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(smi.strip())
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.strip()


def phase_build() -> None:
    from transcar_tpu_torch.ops import kernel_lib

    fresh = not kernel_lib.library_path().exists()
    t0 = time.perf_counter()
    so = kernel_lib.build()
    kernel_lib.library()
    dt = time.perf_counter() - t0
    print(f"build: {so.relative_to(kernel_lib.PACKAGE.parent)} from "
          f"{sorted(p.name for p in kernel_lib.CSRC.glob('*.cu*'))} in "
          f"{dt:.1f} s ({'compiled' if fresh else 'cached'}); ptxas -v: "
          + " | ".join(ptxas_lines(so.with_suffix(".log").read_text())))


def _mangled_names(mangled: str) -> list:
    """The length-prefixed identifiers of an Itanium-mangled name."""
    names, i = [], 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            i += 1
            continue
        n, i = int(m.group()), i + m.end()
        names.append(mangled[i:i + n])
        i += n
    return names


def ptxas_lines(log: str) -> list:
    """One entry per kernel of ``nvcc -Xptxas -v`` output: its name (with
    its integer template arguments), registers, shared memory and
    spills."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            base = [seg for seg in _mangled_names(mangled)
                    if seg.endswith("kernel")]
            args = re.findall(r"L[ib](\d+)E", mangled)
            kind = ("bf16" if "bfloat16" in mangled else
                    "f32" if re.search(r"[IE]f[LE]", mangled) else "")
            name = ((base[-1] if base else mangled)
                    + (f"<{','.join(args + ([kind] if kind else []))}>"
                       if args or kind else ""))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            used = ln.split("Used", 1)[1].split(", ")
            keep = [u.strip() for u in used if "cmem" not in u]
            out.append(f"{name}: {', '.join(keep)}; {spill}")
    return out


def parent_library(csrc: str):
    """The kernel library built from an earlier commit's ``csrc`` (for
    example ``git archive <parent> transcar_tpu_torch/csrc`` unpacked
    under the git-ignored ``transcar_tpu_torch/build/``), to time its
    kernels beside these in the same run."""
    from transcar_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    so = kernel_lib.build(pathlib.Path(csrc).resolve(),
                          kernel_lib.BUILD_DIR / "parent")
    print(f"build parent: {so.name} from {csrc} in "
          f"{time.perf_counter() - t0:.1f} s")
    return ctypes.CDLL(str(so))


def phase_k1() -> dict:
    from transcar_tpu_torch.ops import pallas_dcn
    from transcar_tpu_torch.ops.dcn import modulated_deform_conv

    g = torch.Generator(device="cuda").manual_seed(1)
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bound_by": "operations", "library_ms": None}
    for dtype in (torch.bfloat16, torch.float32):
        for n, h, w, cin, cout, per_req in FLAGSHIP_DCN:
            dev = "cuda"
            x = torch.randn(n, h, w, cin, device=dev, generator=g).to(dtype)
            om = torch.randn(n, h, w, 27, device=dev, generator=g)
            om[..., :18] = (torch.rand(n, h, w, 18, device=dev, generator=g)
                            * 16.0 - 8.0)
            om = om.to(dtype)
            wt = (torch.randn(3, 3, cin, cout, device=dev, generator=g)
                  / math.sqrt(9 * cin)).to(dtype)
            out = pallas_dcn.fused_deform_conv(x, om, wt)
            ref = modulated_deform_conv(x, om, wt)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            dy = om[..., 0:18:2].float().abs()
            past = (dy > 5.0).float().mean().item()
            ms = cuda_ms(lambda: pallas_dcn.fused_deform_conv(x, om, wt))
            plain_ms = cuda_ms(lambda: modulated_deform_conv(x, om, wt))
            ok = math.isfinite(rel) and rel <= DCN_TOL[dtype]
            print(f"K1 dcn {str(dtype)[6:]} x[{n},{h},{w},{cin}]->{cout}: "
                  f"max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                  f"(tol {DCN_TOL[dtype]:.0e} of max|plain|), taps with "
                  f"|dy|>5 px {past:.3f}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {dtype} disagrees with its plain "
                                     f"version: rel err {rel}")
            del ref
            if dtype == torch.bfloat16:     # the main path's dtype
                result["max_abs_err"] = max(result["max_abs_err"], err)
                result["ms"] += per_req * ms
                result["plain_ms"] += per_req * plain_ms
                result["bound_ms"] += per_req * dcn_bound_ms(x, om, wt, out)
            del out
    print(f"K1 per request on the bfloat16 path (23 + 3 launches): kernel "
          f"{result['ms']:.3f} ms, plain {result['plain_ms']:.3f} ms, bound "
          f"{result['bound_ms']:.3f} ms (no single PyTorch call computes "
          f"DCNv2)")
    return result


def dcn_backward_case(g, n, h, w, cin, cout, dtype, offsets: str):
    """Seeded inputs of one DCN backward: x, offset_mask, the float32
    weight parameter and d_out.  ``offsets``: "pm8" draws Δy, Δx over
    ±8 px, "zero" puts every tap on its integer grid position (the mmcv
    init; border taps then sit at py = -1 and py = H), "integer" draws
    whole-pixel offsets in [-3, 3], "model" draws N(0, MODEL_OFFSET_PX²),
    the scale of the benchmark's random DCN offsets (mean |offset| 0.7-3
    px, ``cli/benchmark.py``)."""
    dev = "cuda"
    x = torch.randn(n, h, w, cin, device=dev, generator=g).to(dtype)
    om = torch.randn(n, h, w, 27, device=dev, generator=g)
    if offsets == "pm8":
        om[..., :18] = torch.rand(n, h, w, 18, device=dev, generator=g) * 16 - 8
    elif offsets == "zero":
        om[..., :18] = 0.0
    elif offsets == "model":
        om[..., :18] = torch.randn(n, h, w, 18, device=dev,
                                   generator=g) * MODEL_OFFSET_PX
    else:
        om[..., :18] = torch.randint(-3, 4, (n, h, w, 18), device=dev,
                                     generator=g).float()
    wt = torch.randn(3, 3, cin, cout, device=dev, generator=g) / math.sqrt(9 * cin)
    d_out = torch.randn(n, h, w, cout, device=dev, generator=g).to(dtype)
    return x, om.to(dtype), wt, d_out


def dcn_backward_errors(x, om, wt, d_out):
    """K3 against its plain version: max |kernel − plain| of d_x,
    d_offset_mask and d_W, each over max |plain|, and the largest
    absolute error."""
    from transcar_tpu_torch.ops import pallas_dcn

    got = pallas_dcn.backward_kernel(x, om, wt, d_out)
    ref = pallas_dcn.plain_backward(x, om, wt, d_out)
    torch.cuda.synchronize()
    rels, worst = [], 0.0
    for a, b in zip(got, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"K3 output {tuple(a.shape)} {a.dtype} != "
                                 f"plain {tuple(b.shape)} {b.dtype}")
        err = (a.float() - b.float()).abs().max().item()
        rels.append(err / max(b.float().abs().max().item(), 1e-30))
        worst = max(worst, err)
    return rels, worst


def k3_parts_ms(x, om, wt, d_out) -> tuple:
    """Device ms of K3's two kernels apart: (a) d_x and d_om, (b) d_W,
    each with the zero-fill of its float32 output."""
    from transcar_tpu_torch.ops import pallas_dcn

    n, h, w, cin = x.shape
    w_t = wt.to(x.dtype).contiguous()
    d_x = torch.zeros((n, h, w, cin), dtype=torch.float32, device="cuda")
    d_om = torch.empty_like(om)
    d_w = torch.zeros((9 * cin, wt.shape[-1]), dtype=torch.float32,
                      device="cuda")

    def data():
        d_x.zero_()
        pallas_dcn.backward_data(x, om, w_t, d_out, d_x, d_om)

    def weight():
        d_w.zero_()
        pallas_dcn.backward_weight(x, om, d_out, d_w)
    return cuda_ms(data), cuda_ms(weight)


def parent_dcn_backward(lib, x, om, wt, d_out):
    """The parent commit's K3 (one C entry for both kernels), with its
    wrapper's preparation: ``lib.dcn_backward_bf16``."""
    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    w_t = wt.to(x.dtype).contiguous()
    d_x = torch.zeros((n, h, w, cin), dtype=torch.float32, device="cuda")
    d_om = torch.empty_like(om)
    d_w = torch.zeros((9 * cin, cout), dtype=torch.float32, device="cuda")
    fn = lib.dcn_backward_bf16
    rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (x, om, w_t, d_out,
                                                       d_x, d_om, d_w)),
            n, h, w, cin, cout,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"parent dcn_backward_bf16: CUDA error {rc}")
    return d_x.to(x.dtype), d_om, d_w.reshape(3, 3, cin, cout)


def phase_k3(parent=None) -> dict:
    """K3 against its plain version; per detr3d_r101 step (23 + 3
    launches) in bfloat16, with its two kernels timed apart, and beside
    the parent commit's K3 (``parent``: its kernel library) when given."""
    from transcar_tpu_torch.ops import pallas_dcn

    g = torch.Generator(device="cuda").manual_seed(3)
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bound_by": "operations", "library_ms": None}
    per_step = {"data": 0.0, "weight": 0.0, "model": 0.0, "parent": 0.0,
                "parent_model": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for n, h, w, cin, cout, launches in FLAGSHIP_DCN:
            cases = ("pm8", "zero", "integer") + (
                ("model",) if dtype == torch.bfloat16 else ())
            for offsets in cases:
                x, om, wt, d_out = dcn_backward_case(g, n, h, w, cin, cout,
                                                     dtype, offsets)
                rels, err = dcn_backward_errors(x, om, wt, d_out)
                ok = all(math.isfinite(r) and r <= DCN_BWD_TOL[dtype]
                         for r in rels)
                line = (f"K3 dcn backward {str(dtype)[6:]} x[{n},{h},{w},"
                        f"{cin}]->{cout} offsets {offsets}: d_x / d_om / d_W "
                        f"max_rel_err {rels[0]:.3e} / {rels[1]:.3e} / "
                        f"{rels[2]:.3e} (tol {DCN_BWD_TOL[dtype]:.0e} of "
                        f"max|plain|)")
                timed = offsets == "pm8" or offsets == "model"
                if timed:
                    kern = lambda: pallas_dcn.backward_kernel(x, om, wt, d_out)
                    old = (lambda: parent_dcn_backward(parent, x, om, wt,
                                                       d_out))
                    if parent is not None and dtype == torch.bfloat16:
                        # in turns: parent, kernel, kernel, parent
                        turns = [cuda_ms(f) for f in (old, kern, kern, old)]
                        ms, old_ms = min(turns[1:3]), min(turns[0], turns[3])
                        line += (f"; parent K3 {turns[0]:.3f} / "
                                 f"{turns[3]:.3f} ms, kernel {turns[1]:.3f}"
                                 f" / {turns[2]:.3f} ms")
                    else:
                        ms, old_ms = cuda_ms(kern), 0.0
                        line += f"; kernel {ms:.3f} ms"
                    if offsets == "pm8":
                        plain_ms = cuda_ms(lambda: pallas_dcn.plain_backward(
                            x, om, wt, d_out), iters=5, warmup=1)
                        line += f", plain {plain_ms:.3f} ms"
                    if dtype == torch.bfloat16:
                        a_ms, b_ms = k3_parts_ms(x, om, wt, d_out)
                        line += (f"; (a) d_x + d_om {a_ms:.3f} ms, (b) d_W "
                                 f"{b_ms:.3f} ms")
                    if dtype == torch.bfloat16 and offsets == "pm8":
                        result["max_abs_err"] = max(result["max_abs_err"], err)
                        result["ms"] += launches * ms
                        result["plain_ms"] += launches * plain_ms
                        result["bound_ms"] += launches * dcn_bound_ms(
                            x, om, wt, d_out, backward=True)
                        per_step["data"] += launches * a_ms
                        per_step["weight"] += launches * b_ms
                        per_step["parent"] += launches * old_ms
                    elif dtype == torch.bfloat16:
                        per_step["model"] += launches * ms
                        per_step["parent_model"] += launches * old_ms
                print(line + (" ok" if ok else " FAIL"))
                if not ok:
                    raise AssertionError(f"K3 {dtype} {offsets} disagrees "
                                         f"with its plain version: {rels}")
                del x, om, wt, d_out
    print(f"K3 per detr3d_r101 train step on the bfloat16 path (23 + 3 "
          f"launches), offsets pm8: kernel {result['ms']:.3f} ms ((a) "
          f"{per_step['data']:.3f} + (b) {per_step['weight']:.3f}), plain "
          f"{result['plain_ms']:.3f} ms, bound {result['bound_ms']:.3f} ms"
          + (f", parent K3 {per_step['parent']:.3f} ms (kernel / parent "
             f"{result['ms'] / per_step['parent']:.3f})" if parent else "")
          + f"; offsets at the model's scale: kernel {per_step['model']:.3f}"
          + (f" ms, parent {per_step['parent_model']:.3f}" if parent else "")
          + " ms (no single PyTorch call computes the DCNv2 backward)")
    return result


def phase_k2() -> dict:
    from transcar_tpu_torch.ops import pallas_attention
    from transcar_tpu_torch.ops.attention import attention_core

    g = torch.Generator(device="cuda").manual_seed(2)
    b, heads, nq, t, hd = 1, 8, 900, 1500, 32
    qh = torch.randn(b, heads, nq, hd, device="cuda", generator=g)
    kh = torch.randn(b, heads, t, hd, device="cuda", generator=g)
    vh = torch.randn(b, heads, t, hd, device="cuda", generator=g)
    keep = torch.rand(b, nq, t, device="cuda", generator=g) < 0.2
    keep[:, 0] = True                  # a fully-visible row
    keep[:, 1] = False                 # fully-masked rows
    keep[:, 899] = False
    out = pallas_attention.masked_attention(qh, kh, vh, keep)
    ref = attention_core(qh, kh, vh, ~keep)
    torch.cuda.synchronize()
    gate = keep.any(-1)                # rows with ≥ 1 visible token
    diff = (out - ref).abs().transpose(1, 2)[gate]
    err = diff.max().item()
    rel = (diff / (ref.abs().transpose(1, 2)[gate] + 1.0)).max().item()
    finite = bool(torch.isfinite(out).all())
    ms = cuda_ms(lambda: pallas_attention.masked_attention(qh, kh, vh, keep))
    plain_ms = cuda_ms(lambda: attention_core(qh, kh, vh, ~keep))
    # the library yardstick: one PyTorch call over the same inputs (its
    # fully-masked rows come out NaN; it is timed, not checked)
    sdpa_mask = keep[:, None]
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=sdpa_mask))
    bound, bound_by = bound_ms(4.0 * b * heads * nq * t * hd, torch.float32,
                               nbytes(qh, kh, vh, keep, out))
    ok = finite and err <= ATTN_TOL
    print(f"K2 attention [{b}x{heads}, {nq}x{t}, hd {hd}] keep density "
          f"{keep.float().mean().item():.3f}, gated rows "
          f"{int(gate.sum())}/{nq}: max_abs_err {err:.3e} max_rel_err "
          f"{rel:.3e} (tol {ATTN_TOL:.0e}), all finite {finite}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K2 disagrees with its plain version")
    return {"max_abs_err": err, "ms": 3 * ms, "plain_ms": 3 * plain_ms,
            "bound_ms": 3 * bound, "bound_by": bound_by,
            "library_ms": 3 * library_ms}


def phase_slice(smi: str) -> dict:
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.models.resnet import RESNET_DEPTHS

    preset = "transcar_r101"
    cfg = get_preset(preset)
    depths = RESNET_DEPTHS[int(cfg.model.backbone.kind[6:])]
    per_req = {"dcn_forward": sum(d for d, dcn in zip(
                   depths, cfg.model.backbone.with_dcn) if dcn),        # 26
               "masked_attention": cfg.model.head.num_fusion_layers}    # 3
    plain = ["model.backbone.dcn_impl=exact",
             "model.head.use_pallas_attention=false"]

    # the main path: bfloat16 backbone, float32 head, through the kernels
    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    want = {k: per_req.get(k, 0) * rec["requests"]
            for k in rec["kernel_launches"]}
    valid = _check_outputs("slice", out, cfg)
    print(f"slice {preset} 6x928x1600 bs1 (bf16 backbone, fp32 head): "
          f"{rec['requests']} requests, launches {rec['kernel_launches']} "
          f"(want {per_req} per request, no other kernel); outputs finite; "
          f"decode {valid}/300 valid boxes; DCN taps with |dy|>5 px "
          f"{rec['dcn_taps_past_5px']:.4f}; fusion keeps "
          f"{rec['fusion_keep_share']:.3e} of (query, token) pairs")
    if rec["kernel_launches"] != want:
        raise AssertionError(f"kernel launches {rec['kernel_launches']} != "
                             f"{want}")

    # float32 backbone: the kernel path against the plain path.  The
    # random-weight decoder amplifies any perturbation about 10x per layer
    # (measured on an H100: FPN levels agree to 4e-6, the six decoder
    # layers' outputs then to 2e-6, 1e-4, 1e-3, 2e-2, 0.14 and 1.05), so
    # this check keeps one decoder layer: full backbone and FPN (26 K1
    # launches), one decoder layer, the 3 fusion layers (3 K2 launches).
    worst = _fp32_vs_plain(preset, [], plain)
    print(f"slice fp32 (1 decoder layer) kernel path vs plain path: max "
          f"|diff|/(1+|plain|) {worst:.3e} (tol {SLICE_TOL:.0e}) "
          f"{'ok' if worst <= SLICE_TOL else 'FAIL'}")
    if not worst <= SLICE_TOL:
        raise AssertionError("fp32 slice: kernel path disagrees with plain")

    plain_rec, _ = benchmark.run([preset, "--samples", "10", "--warmup", "3",
                                  "--cfg-options", *plain])
    print(f"slice bf16 kernel path: {rec['samples_per_sec']:.3f} samples/s "
          f"({rec['ms_per_sample']:.2f} ms/sample) on {smi}")
    print(f"slice bf16 plain path: {plain_rec['samples_per_sec']:.3f} "
          f"samples/s ({plain_rec['ms_per_sample']:.2f} ms/sample) on {smi}")
    return {k: rec["kernel_launches"][k] for k in per_req}


def _sync_check_armed() -> None:
    """Positive control of the sync check: in PyTorch's sync debug mode
    "error", a pageable host-to-device copy must raise on this card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.tensor([1.0], device="cuda")
    except RuntimeError:
        return
    finally:
        torch.cuda.set_sync_debug_mode(0)
    raise AssertionError("torch.cuda.set_sync_debug_mode('error') did not "
                         "flag a pageable host-to-device copy")


def warm_request_syncs(preset: str) -> list:
    """One warm batch-1 serving request of ``preset`` at full width under
    ``torch.cuda.set_sync_debug_mode("error")``; the host synchronization
    it made, if any."""
    from transcar_tpu_torch.cli import benchmark

    args = benchmark.parse_args([preset])
    _, model, batch, _ = benchmark._setup(args, training=False)
    inputs = ([batch["points"], batch["num_points"]] if "points" in batch
              else [batch["images"], batch["lidar2img"],
                    batch.get("radar_tokens")])
    found = []
    with torch.inference_mode():
        model(*inputs)                                   # warmup
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(*inputs)
        except RuntimeError as e:
            found.append(str(e).splitlines()[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    del model, batch, inputs
    torch.cuda.empty_cache()
    return found


def phase_sync() -> None:
    """No host sync in a warm camera serving request (``transcar_r101``,
    ``transcar_vovnet_trainval``); ``objdgcnn_pillar`` is reported."""
    _sync_check_armed()
    for preset in ("transcar_r101", "transcar_vovnet_trainval",
                   "objdgcnn_pillar"):
        found = warm_request_syncs(preset)
        print(f"sync check (set_sync_debug_mode, armed) {preset} warm bs1 "
              f"request: "
              + ("no host sync ok" if not found else f"host syncs {found}")
              + (" (reported only)" if preset == "objdgcnn_pillar" else ""))
        if found and preset != "objdgcnn_pillar":
            raise AssertionError(f"{preset}: a serving request synchronized "
                                 f"with the host: {found}")


def _initial_state(preset: str, cfg_options=()) -> tuple:
    """The parameters and buffers ``benchmark --train`` starts from (same
    seed, same randomized DCN and MSDeformAttn offsets), on the card."""
    from transcar_tpu_torch.cli import benchmark

    args = benchmark.parse_args([preset, "--train", "--cfg-options",
                                 *cfg_options])
    _, model, _, _ = benchmark._setup(args, training=True)
    return ({n: p.detach() for n, p in model.named_parameters()},
            {n: b.detach().clone() for n, b in model.named_buffers()})


def _moved(state, start: dict):
    """(trainable moved, trainable total, frozen moved, frozen total,
    trainable unmoved that are zero with a zero gradient).  AdamW moves
    every trainable tensor (weight decay alone shrinks it) except a zero
    one whose gradient is zero: a zero-initialized bias that the loss
    never reaches, as fusion attention is where no (query, radar token)
    pair is kept."""
    counts = [0, 0, 0, 0, 0]
    for name, p in state.model.named_parameters():
        moved = not torch.equal(p.detach(), start[name])
        k = 0 if p.requires_grad else 2
        counts[k] += int(moved)
        counts[k + 1] += 1
        if p.requires_grad and not moved and not p.detach().any() and (
                p.grad is None or not p.grad.any()):
            counts[4] += 1
    return counts


def phase_train(smi: str) -> dict:
    """Both recipes at full width through ``benchmark --train``."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.models.detector import resolve_remat
    from transcar_tpu_torch.models.resnet import RESNET_DEPTHS
    from transcar_tpu_torch.ops import pallas_attention, pallas_dcn

    out = {}
    for preset, warmup, timed in (("detr3d_r101", 2, 5),
                                  ("transcar_r101", 2, 5)):
        cfg = get_preset(preset)
        depths = RESNET_DEPTHS[int(cfg.model.backbone.kind[6:])]
        n_dcn = sum(d for d, dcn in zip(depths, cfg.model.backbone.with_dcn)
                    if dcn)                                           # 26
        start, _ = _initial_state(preset)
        # this recipe's path, counts at 0 just before and read just after
        _zero_counts()
        rec, state = benchmark.run_train([preset, "--train", "--samples",
                                          str(timed), "--warmup",
                                          str(warmup)])
        launches = (pallas_dcn.launches, pallas_dcn.backward_launches,
                    pallas_attention.launches)
        steps = rec["steps"]
        fusion_only = rec["fusion_only"]
        remat = resolve_remat(cfg) and not fusion_only
        want = (n_dcn * steps * (2 if remat else 1),
                0 if fusion_only else n_dcn * steps, 0)
        moved = _moved(state, start)
        finite = all(math.isfinite(v) for r in (rec["loss_first"],
                                                rec["loss_last"])
                     for v in r.values())
        print(f"train {preset} 6x928x1600 bs1 (bf16 backbone, fp32 head, "
              f"{'fusion-only' if fusion_only else 'full backbone'}): "
              f"{steps} steps, launches K1 {launches[0]} K3 {launches[1]} "
              f"K2 {launches[2]} (want {want}: K1 {want[0] // steps} and K3 "
              f"{want[1] // steps} per step); loss total first "
              f"{rec['loss_first']['total']:.4f} last "
              f"{rec['loss_last']['total']:.4f}, finite {finite}; trainable "
              f"tensors moved {moved[0]}/{moved[1]} (unmoved: {moved[4]} zero "
              f"with zero gradient), frozen moved {moved[2]}/{moved[3]}; "
              f"peak memory "
              f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB; "
              f"{rec['ms_per_step']:.2f} ms/step, {rec['steps_per_sec']:.3f} "
              f"steps/s on {smi}")
        if launches != want:
            raise AssertionError(f"train {preset}: launches {launches} != "
                                 f"{want}")
        if not finite:
            raise AssertionError(f"train {preset}: non-finite loss")
        if moved[0] + moved[4] != moved[1] or moved[2] != 0 or moved[0] == 0:
            raise AssertionError(f"train {preset}: moved {moved} (every "
                                 "trainable tensor must move unless it is "
                                 "zero with a zero gradient; no frozen one)")
        if fusion_only and any(
                n.startswith(("backbone.", "neck.", "head.decoder"))
                for n, p in state.model.named_parameters() if p.requires_grad):
            raise AssertionError("fusion-only: a camera parameter trains")
        out[preset] = {"launches": launches, "record": rec}
        del state, start
        torch.cuda.empty_cache()
    return out


def phase_train_check() -> None:
    """One float32 train step of each recipe, kernel path against plain
    path (the DCN plain version under autograd; training attention is the
    plain formulation on both).  Dropout and GridMask are off and the
    decoder keeps one layer, as phase_slice does.  The backbone is cut to
    ResNet-50 depth (6 + 3 DCN blocks instead of 23 + 3): the plain DCN's
    autograd keeps four float32 corner gathers of [N·H·W·9, Cin] per conv,
    ~1.6 GB per layer-3 conv at full width, which a full-depth float32
    plain step would not fit beside the rest in 80 GB."""
    from transcar_tpu_torch.cli import benchmark

    opts = ["model.backbone.kind=resnet50",
            "model.backbone.compute_dtype=float32",
            "model.head.num_decoder_layers=1", "model.use_grid_mask=false"]
    plain = ["model.backbone.dcn_impl=exact",
             "model.head.use_pallas_attention=false"]
    for preset in ("detr3d_r101", "transcar_r101"):
        runs = []
        for extra in ([], plain):
            start, _ = _initial_state(preset, opts + extra)
            rec, state = benchmark.run_train(
                [preset, "--train", "--samples", "1", "--warmup", "0",
                 "--dropout", "0", "--cfg-options", *opts, *extra])
            runs.append((rec, state, start))
        (rk, sk, p0), (rp, sp, _) = runs
        loss_err = max(abs(rk["loss_first"][k] - rp["loss_first"][k])
                       / max(abs(rp["loss_first"][k]), 1e-12)
                       for k in rp["loss_first"])
        gn_k, gn_p = float(sk.grad_norm), float(sp.grad_norm)
        gn_err = abs(gn_k - gn_p) / max(gn_p, 1e-12)
        # the lr of the step taken (the schedule at step 0, main group)
        lr = max(sp.scheduler.base_lrs) * sp.scheduler.lr_lambdas[0](0)
        pk = dict(sk.model.named_parameters())
        worst, tight, total = 0.0, 0, 0
        for name, p in sp.model.named_parameters():
            d = (pk[name].detach().double() - p.detach().double()).abs()
            worst = max(worst, d.max().item() / lr)
            tight += int((d <= PARAM_TIGHT * lr).sum())
            total += d.numel()
        moved = sum(int((pk[n].detach() != p0[n]).any()) for n in pk)
        ok = (loss_err <= STEP_TOL and gn_err <= STEP_TOL and worst <= 2.0
              and tight >= PARAM_SHARE * total and moved > 0)
        print(f"train check {preset} fp32 (R50 depth, 1 decoder layer, "
              f"dropout and GridMask off), kernel vs plain, one step: loss "
              f"rel err {loss_err:.3e}, grad-norm {gn_k:.6f} vs {gn_p:.6f} "
              f"(rel {gn_err:.3e}, tol {STEP_TOL:.0e}); params after the "
              f"step: max |diff| {worst:.3e} lr, within {PARAM_TIGHT:.0e} lr "
              f"{tight}/{total} (need {PARAM_SHARE}); tensors moved {moved} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train check {preset}: kernel path "
                                 "disagrees with the plain path")
        del runs, sk, sp, pk, p0
        torch.cuda.empty_cache()


def _rel_err(got, ref) -> tuple:
    """(max |got − ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def _affine(g, c):
    return (torch.rand(c, device="cuda", generator=g) + 0.5,
            torch.randn(c, device="cuda", generator=g) * 0.1)


def _kernel_result() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": "operations", "library_ms": None}


def parent_osa_reduce(lib, pieces, ws, s, b):
    """The parent commit's K4 (its wmma tile) with its wrapper's
    preparation: ``lib.osa_reduce_bf16`` on contiguous [Cᵢ, Cout]
    weights."""
    n, h, w, _ = pieces[0].shape
    cout, k = ws[0].shape[-1], len(pieces)
    ws = [wi.contiguous() for wi in ws]
    out = torch.empty((n, h, w, cout), dtype=pieces[0].dtype, device="cuda")
    sums = torch.zeros((n, cout), dtype=torch.float32, device="cuda")
    ptrs = ctypes.c_void_p * k
    rc = lib.osa_reduce_bf16(
        k, ptrs(*[p.data_ptr() for p in pieces]),
        ptrs(*[wi.data_ptr() for wi in ws]),
        (ctypes.c_int * k)(*[p.shape[-1] for p in pieces]),
        *(ctypes.c_void_p(t.data_ptr()) for t in (s, b, out, sums)),
        n, h, w, cout, 1,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"parent osa_reduce_bf16: CUDA error {rc}")
    return out, sums


def phase_k4(parent=None) -> dict:
    """K4 at the 7 VoVNet-99 block shapes; per request (16 launches) in
    bfloat16 beside one cuDNN 1×1 convolution over the concatenation, and
    beside the parent commit's K4 (``parent``: its kernel library) when
    given.  The bfloat16 weights are the K-major views the model caches
    (``pallas_osa.kmajor_weights``)."""
    from transcar_tpu_torch.ops import pallas_osa

    g = torch.Generator(device="cuda").manual_seed(4)
    res = _kernel_result()
    res["library_ms"] = 0.0
    parent_ms = 0.0
    bound_kinds = set()
    for dtype in (torch.bfloat16, torch.float32):
        for h, w, c0, ch, cout, per_req in VOV_BLOCKS:
            n, widths = 6, [c0] + [ch] * 5
            pieces = [torch.randn(n, h, w, c, device="cuda", generator=g)
                      .to(dtype) for c in widths]
            w_all = (torch.randn(cout, sum(widths), device="cuda",
                                 generator=g) / math.sqrt(sum(widths)))
            ws = pallas_osa.kmajor_weights(w_all, widths, dtype)
            s, b = _affine(g, cout)
            before = pallas_osa.wgmma_launches
            out, sums = pallas_osa.osa_reduce(pieces, ws, s, b)
            took = pallas_osa.wgmma_launches - before
            ref, ref_sums = pallas_osa.plain_osa_reduce(pieces, ws, s, b)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            _, srel = _rel_err(sums, ref_sums)
            want_tile = int(dtype == torch.bfloat16)
            ok = (math.isfinite(rel) and rel <= CONV_TOL[dtype]
                  and srel <= SUMS_TOL and took == want_tile)
            line = (f"K4 osa_reduce {str(dtype)[6:]} 6x{h}x{w} "
                    f"sum(C)={sum(widths)}->{cout} "
                    f"({'wgmma tile' if took else 'wmma tile'}): "
                    f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol "
                    f"{CONV_TOL[dtype]:.0e}), sums rel err {srel:.3e} (tol "
                    f"{SUMS_TOL:.0e})")
            if dtype == torch.bfloat16:         # the main path's dtype
                del ref, ref_sums
                kern = lambda: pallas_osa.osa_reduce(pieces, ws, s, b)
                if parent is not None:
                    wc = [wi.contiguous() for wi in ws]
                    old = lambda: parent_osa_reduce(parent, pieces, wc, s, b)
                    turns = [cuda_ms(f) for f in (old, kern, kern, old)]
                    ms, old_ms = min(turns[1:3]), min(turns[0], turns[3])
                    parent_ms += per_req * old_ms
                    line += (f"; parent K4 {turns[0]:.3f} / {turns[3]:.3f} "
                             f"ms, kernel {turns[1]:.3f} / {turns[2]:.3f} ms")
                else:
                    ms = cuda_ms(kern)
                    line += f"; kernel {ms:.3f} ms"
                plain_ms = cuda_ms(lambda: pallas_osa.plain_osa_reduce(
                    pieces, ws, s, b), iters=5, warmup=1)
                # the library yardstick: one cuDNN 1×1 conv over the
                # concatenation, built beforehand and not timed
                xcat = torch.cat(pieces, -1).permute(0, 3, 1, 2)
                wcat = w_all.to(dtype)[:, :, None, None].contiguous(
                    memory_format=torch.channels_last)
                lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(xcat,
                                                                    wcat))
                del xcat, wcat
                bound, kind = bound_ms(2.0 * n * h * w * sum(widths) * cout,
                                       dtype, nbytes(*pieces, *ws, s, b, out,
                                                     sums))
                bound_kinds.add(kind)
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["ms"] += per_req * ms
                res["plain_ms"] += per_req * plain_ms
                res["library_ms"] += per_req * lib_ms
                res["bound_ms"] += per_req * bound
                line += (f", plain {plain_ms:.3f} ms, cuDNN 1x1 conv over "
                         f"the concatenation {lib_ms:.3f} ms, bound "
                         f"{bound:.3f} ms by {kind} (kernel at "
                         f"{bound / ms:.0%} of it)")
            print(line + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"K4 {dtype} 6x{h}x{w} disagrees with "
                                     f"its plain version ({rel}, sums {srel})"
                                     f" or took the wrong tile ({took})")
            del pieces, ws, out, sums
    res["bound_by"] = "operations" if "operations" in bound_kinds else "bytes"
    print(f"K4 per request on the bfloat16 path (16 launches): kernel "
          f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, cuDNN 1x1 "
          f"conv {res['library_ms']:.3f} ms (kernel / cuDNN "
          f"{res['ms'] / res['library_ms']:.3f}), bound {res['bound_ms']:.3f}"
          f" ms ({res['bound_ms'] / res['ms']:.0%} of it)"
          + (f", parent K4 {parent_ms:.3f} ms (kernel / parent "
             f"{res['ms'] / parent_ms:.3f})" if parent is not None else ""))
    return res


def phase_k5() -> dict:
    """K5 at the 7 VoVNet-99 block shapes; per request (16 calls)."""
    from transcar_tpu_torch.ops import pallas_osa_block

    g = torch.Generator(device="cuda").manual_seed(5)
    res = _kernel_result()
    for dtype in (torch.bfloat16, torch.float32):
        for h, w, c0, ch, cout, per_req in VOV_BLOCKS:
            n = 6
            x = torch.randn(n, h, w, c0, device="cuda", generator=g).to(dtype)
            w9s, affs, cin = [], [], c0
            for _ in range(5):
                w9s.append((torch.randn(3, 3, cin, ch, device="cuda",
                                        generator=g)
                            / math.sqrt(9 * cin)).to(dtype))
                affs.append(_affine(g, ch))
                cin = ch
            widths = [c0] + [ch] * 5
            rws = [(torch.randn(c, cout, device="cuda", generator=g)
                    / math.sqrt(sum(widths))).to(dtype) for c in widths]
            raff = _affine(g, cout)
            args = (x, w9s, affs, rws, raff)
            out, sums = pallas_osa_block.osa_block_fused(*args)
            ref, ref_sums = pallas_osa_block.plain_osa_block(*args)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            _, srel = _rel_err(sums, ref_sums)
            stol = SUMS_TOL if dtype == torch.float32 else CHAIN_TOL[dtype]
            ok = math.isfinite(rel) and rel <= CHAIN_TOL[dtype] and srel <= stol
            line = (f"K5 osa_block {str(dtype)[6:]} 6x{h}x{w} {c0}->5x{ch}"
                    f"->{cout}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                    f"(tol {CHAIN_TOL[dtype]:.0e}), sums rel err {srel:.3e} "
                    f"(tol {stol:.0e})")
            if dtype == torch.bfloat16:
                del ref, ref_sums
                ms = cuda_ms(lambda: pallas_osa_block.osa_block_fused(*args),
                             iters=10)
                plain_ms = cuda_ms(lambda: pallas_osa_block.plain_osa_block(
                    *args), iters=3, warmup=1)
                flops = 2.0 * n * h * w * (9 * (c0 * ch + 4 * ch * ch)
                                           + sum(widths) * cout)
                bound, kind = bound_ms(flops, dtype, nbytes(
                    x, *w9s, *rws, *[t for a in affs for t in a], *raff,
                    out, sums))
                res["bound_by"] = kind
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["ms"] += per_req * ms
                res["plain_ms"] += per_req * plain_ms
                res["bound_ms"] += per_req * bound
                line += (f"; kernel {ms:.3f} ms (6 device kernels), plain "
                         f"{plain_ms:.3f} ms, bound {bound:.3f} ms by {kind}")
            print(line + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"K5 {dtype} 6x{h}x{w} disagrees with "
                                     f"its plain version: {rel}, sums {srel}")
            del x, w9s, rws, out, sums, args
    print(f"K5 per request on the bfloat16 path (16 calls): kernel "
          f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
          f"{res['bound_ms']:.3f} ms (no single PyTorch call computes an OSA "
          f"block)")
    return res


def phase_k6() -> dict:
    """K6 at the 3 R101 stride-1 non-DCN bottleneck shapes; per request
    of ``transcar_r101`` with ``block_impl=fused`` (6 calls)."""
    from transcar_tpu_torch.ops import pallas_bottleneck

    g = torch.Generator(device="cuda").manual_seed(6)
    res = _kernel_result()
    for dtype in (torch.bfloat16, torch.float32):
        for h, w, cin, cm, cout, ds, per_req in R101_K6:
            n = 6
            x = torch.randn(n, h, w, cin, device="cuda", generator=g).to(dtype)
            k = lambda *sh: (torch.randn(*sh, device="cuda", generator=g)
                             / math.sqrt(sh[0] * sh[1] * sh[2])).to(dtype)
            ws = [k(1, 1, cin, cm), k(3, 3, cm, cm), k(1, 1, cm, cout)]
            affs = [_affine(g, cm), _affine(g, cm), _affine(g, cout)]
            kw = dict(wd=k(1, 1, cin, cout), affd=_affine(g, cout)) if ds else {}
            args = (x, ws[0], affs[0], ws[1], affs[1], ws[2], affs[2])
            out = pallas_bottleneck.bottleneck_fused(*args, **kw)
            ref = pallas_bottleneck.plain_bottleneck(*args, **kw)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            ok = math.isfinite(rel) and rel <= CHAIN_TOL[dtype]
            line = (f"K6 bottleneck {str(dtype)[6:]} 6x{h}x{w} {cin}->{cm}->"
                    f"{cout}{' +downsample' if ds else ''}: max_abs_err "
                    f"{err:.3e} max_rel_err {rel:.3e} (tol "
                    f"{CHAIN_TOL[dtype]:.0e})")
            if dtype == torch.bfloat16:
                del ref
                ms = cuda_ms(lambda: pallas_bottleneck.bottleneck_fused(
                    *args, **kw))
                plain_ms = cuda_ms(lambda: pallas_bottleneck.plain_bottleneck(
                    *args, **kw), iters=5, warmup=1)
                flops = 2.0 * n * h * w * (cin * cm + 9 * cm * cm + cm * cout
                                           + (cin * cout if ds else 0))
                extra = [kw["wd"], *kw["affd"]] if ds else []
                bound, kind = bound_ms(flops, dtype, nbytes(
                    x, *ws, *[t for a in affs for t in a], *extra, out))
                res["bound_by"] = kind
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["ms"] += per_req * ms
                res["plain_ms"] += per_req * plain_ms
                res["bound_ms"] += per_req * bound
                line += (f"; kernel {ms:.3f} ms (3 device kernels), plain "
                         f"{plain_ms:.3f} ms, bound {bound:.3f} ms by {kind}")
            print(line + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"K6 {dtype} 6x{h}x{w} disagrees with "
                                     f"its plain version: {rel}")
            del x, ws, out, args, kw
    print(f"K6 per request on the bfloat16 path (6 calls): kernel "
          f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
          f"{res['bound_ms']:.3f} ms (no single PyTorch call computes a "
          f"bottleneck)")
    return res


def _zero_counts() -> None:
    from transcar_tpu_torch.ops import (pallas_attention, pallas_bottleneck,
                                        pallas_dcn, pallas_osa,
                                        pallas_osa_block)

    from transcar_tpu_torch.ops import pallas_msdeform

    pallas_dcn.launches = pallas_dcn.backward_launches = 0
    pallas_attention.launches = pallas_osa.launches = 0
    pallas_osa.wgmma_launches = 0
    pallas_osa_block.launches = pallas_bottleneck.launches = 0
    pallas_msdeform.launches = 0
    pallas_msdeform.backward_taps_launches = 0
    pallas_msdeform.backward_value_launches = 0


def _fp32_vs_plain(preset: str, kernel_opts, plain_opts) -> float:
    """One float32 request with one decoder layer through the kernel path
    and through the plain path; the largest |diff| / (1 + |plain|)."""
    from transcar_tpu_torch.cli import benchmark

    f32 = [preset, "--samples", "1", "--warmup", "0", "--cfg-options",
           "model.backbone.compute_dtype=float32",
           "model.head.num_decoder_layers=1"]
    _, k32 = benchmark.run(f32 + list(kernel_opts))
    _, p32 = benchmark.run(f32 + list(plain_opts))
    worst = 0.0
    for key in k32:
        a, b = k32[key].double(), p32[key].double()
        worst = max(worst, ((a - b).abs() / (1 + b.abs())).max().item())
    return worst


def _check_outputs(name: str, out, cfg) -> int:
    """Finite head outputs of the expected shape and a finite decode;
    returns the count of valid decoded boxes."""
    from transcar_tpu_torch.eval.decode import nms_free_decode

    layers = cfg.model.head.num_fusion_layers
    for key, val in out.items():
        if val.shape != (layers, 1, 900, 10) or not torch.isfinite(val).all():
            raise AssertionError(f"{name} {key}: shape {tuple(val.shape)}, "
                                 f"finite {bool(torch.isfinite(val).all())}")
    dec = nms_free_decode(out, cfg.model.head)
    if dec["boxes"].shape != (1, 300, 9) or not torch.isfinite(
            dec["boxes"]).all():
        raise AssertionError(f"{name} decode: bad boxes")
    return int(dec["valid"].sum())


def phase_vovnet_slice(smi: str) -> dict:
    """``transcar_vovnet_trainval`` batch-1 inference at full width."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.models.vovnet import V99_SPEC

    preset = "transcar_vovnet_trainval"
    cfg = get_preset(preset)
    per_req = {"osa_reduce": sum(V99_SPEC["block_per_stage"]),       # 16
               "masked_attention": cfg.model.head.num_fusion_layers,   # 3
               "dcn_forward": 0}
    from transcar_tpu_torch.ops import pallas_osa

    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    got = {k: rec["kernel_launches"][k] for k in per_req}
    want = {k: v * rec["requests"] for k, v in per_req.items()}
    wgmma = pallas_osa.wgmma_launches
    valid = _check_outputs("vovnet slice", out, cfg)
    print(f"vovnet slice {preset} 6x928x1600 bs1 (V-99-eSE bf16 backbone, "
          f"FPN from stage 2, fp32 head): {rec['requests']} requests, "
          f"launches {got} (want {want}), K4 on the wgmma tile {wgmma} of "
          f"{got['osa_reduce']}; outputs finite; decode {valid}/300 "
          f"valid boxes; DCN audit {rec['dcn_taps_past_5px']} (no DCN); "
          f"fusion keeps {rec['fusion_keep_share']:.3e} of (query, token) "
          f"pairs")
    if got != want or any(v for k, v in rec["kernel_launches"].items()
                          if k not in per_req):
        raise AssertionError(f"vovnet slice launches {rec['kernel_launches']}"
                             f" != {want}")
    if wgmma != got["osa_reduce"]:
        raise AssertionError(f"vovnet slice: {got['osa_reduce'] - wgmma} K4 "
                             "launches missed the wgmma tile")
    plain = ["model.backbone.osa_reduce_impl=xla",
             "model.head.use_pallas_attention=false"]
    worst = _fp32_vs_plain(preset, [], plain)
    print(f"vovnet slice fp32 (1 decoder layer) kernel path vs plain path: "
          f"max |diff|/(1+|plain|) {worst:.3e} (tol {SLICE_TOL:.0e}) "
          f"{'ok' if worst <= SLICE_TOL else 'FAIL'}")
    if not worst <= SLICE_TOL:
        raise AssertionError("fp32 vovnet slice: kernel path disagrees with "
                             "plain")
    plain_rec, _ = benchmark.run([preset, "--samples", "10", "--warmup", "3",
                                  "--cfg-options", *plain])
    for name, r in (("kernel", rec), ("plain", plain_rec)):
        print(f"vovnet slice bf16 {name} path: {r['samples_per_sec']:.3f} "
              f"samples/s ({r['ms_per_sample']:.2f} ms/sample), peak memory "
              f"{r['peak_memory_bytes'] / 2**30:.2f} GiB on {smi}")
    return got


def phase_k5_path(smi: str) -> int:
    """The full-width VoVNet-99 backbone with K5 in every block against
    the K4 default, on the four stage outputs."""
    from transcar_tpu_torch.models.detector import init_weights
    from transcar_tpu_torch.models.vovnet import VoVNet
    from transcar_tpu_torch.ops import pallas_osa, pallas_osa_block

    x = torch.randn(6, 3, 928, 1600, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    x = x.contiguous(memory_format=torch.channels_last)
    k5 = 0
    for dtype in ("float32", "bfloat16"):
        nets = {}
        for impl in ("pallas", "fused"):
            net = VoVNet(compute_dtype=dtype, stage_impls=(impl,) * 4)
            init_weights(net, torch.Generator().manual_seed(0))
            nets[impl] = net.to(device="cuda",
                                memory_format=torch.channels_last).eval()
        with torch.inference_mode():
            _zero_counts()
            fused = nets["fused"](x)
            torch.cuda.synchronize()
            counts = (pallas_osa_block.launches, pallas_osa.launches)
            default = nets["pallas"](x)
            k4 = pallas_osa.launches - counts[1]
            if counts != (16, 0) or k4 != 16:
                raise AssertionError(f"K5 path launches K5/K4 {counts}, K4 "
                                     f"path K4 {k4}; want (16, 0) and 16")
            rels = [_rel_err(a, b)[1] for a, b in zip(fused, default)]
            finite = all(bool(torch.isfinite(a).all()) for a in fused)
            # timed in bfloat16 only: the K4 path's float32 chain convs
            # take cuDNN's slow non-TF32 route (seconds per forward)
            timing = "" if dtype == "float32" else (
                f"; backbone K5 path "
                f"{cuda_ms(lambda: nets['fused'](x), iters=5, warmup=1):.2f}"
                f" ms, K4 path "
                f"{cuda_ms(lambda: nets['pallas'](x), iters=5, warmup=1):.2f}"
                f" ms on {smi}")
        ok = finite and (dtype == "bfloat16" or max(rels) <= BACKBONE_TOL)
        print(f"K5 path VoVNet-99 {dtype} 6x3x928x1600: 16 K5 launches; "
              f"stage 2-5 max_rel_err vs the K4 path "
              + " / ".join(f"{r:.3e}" for r in rels)
              + (f" (tol {BACKBONE_TOL:.0e})" if dtype == "float32"
                 else " (reported; bf16 rounds at other places)")
              + f", finite {finite}{timing} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K5 path disagrees with the K4 path")
        k5 = counts[0]
        del nets, fused, default
        torch.cuda.empty_cache()
    return k5


def phase_k6_path(smi: str) -> int:
    """``transcar_r101`` with ``block_impl=fused``: launches, float32
    against the plain path, samples/s beside the default path."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset

    preset, fused = "transcar_r101", "model.backbone.block_impl=fused"
    per_req = {"bottleneck": 6, "dcn_forward": 26, "masked_attention": 3}
    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3",
                              "--cfg-options", fused])
    got = {k: rec["kernel_launches"][k] for k in per_req}
    want = {k: v * rec["requests"] for k, v in per_req.items()}
    valid = _check_outputs("K6 path", out, get_preset(preset))
    print(f"K6 path {preset} block_impl=fused 6x928x1600 bs1: launches {got}"
          f" (want {want}); outputs finite; decode {valid}/300 valid boxes")
    if got != want:
        raise AssertionError(f"K6 path launches {got} != {want}")
    plain = ["model.backbone.dcn_impl=exact",
             "model.head.use_pallas_attention=false"]
    worst = _fp32_vs_plain(preset, [fused], plain)
    print(f"K6 path fp32 (1 decoder layer) kernel path vs plain path: max "
          f"|diff|/(1+|plain|) {worst:.3e} (tol {SLICE_TOL:.0e}) "
          f"{'ok' if worst <= SLICE_TOL else 'FAIL'}")
    if not worst <= SLICE_TOL:
        raise AssertionError("fp32 K6 path disagrees with plain")
    default, _ = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    print(f"K6 path bf16: block_impl=fused {rec['samples_per_sec']:.3f} "
          f"samples/s ({rec['ms_per_sample']:.2f} ms/sample), default "
          f"{default['samples_per_sec']:.3f} samples/s "
          f"({default['ms_per_sample']:.2f} ms/sample) on {smi}")
    return got["bottleneck"]


def phase_vovnet_train(smi: str) -> None:
    """One ``transcar_vovnet_trainval --train`` run: fusion-only."""
    from transcar_tpu_torch.cli import benchmark

    preset = "transcar_vovnet_trainval"
    start, _ = _initial_state(preset)
    _zero_counts()
    rec, state = benchmark.run_train([preset, "--train", "--samples", "5",
                                      "--warmup", "2"])
    moved = _moved(state, start)
    finite = all(math.isfinite(v) for r in (rec["loss_first"],
                                            rec["loss_last"])
                 for v in r.values())
    camera = [n for n, p in state.model.named_parameters()
              if n.startswith(("backbone.", "neck.", "head.decoder"))
              and (p.requires_grad or not torch.equal(p.detach(), start[n]))]
    print(f"train {preset} 6x928x1600 bs1 (fusion-only, camera forward "
          f"without a graph, plain OSA tail): {rec['steps']} steps, "
          f"launches {rec['kernel_launches']}; loss total first "
          f"{rec['loss_first']['total']:.4f} last "
          f"{rec['loss_last']['total']:.4f}, finite {finite}; trainable "
          f"tensors moved {moved[0]}/{moved[1]} (unmoved: {moved[4]} zero "
          f"with zero gradient), frozen moved {moved[2]}/{moved[3]}; peak "
          f"memory {rec['peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"{rec['ms_per_step']:.2f} ms/step, {rec['steps_per_sec']:.3f} "
          f"steps/s on {smi}")
    if not (rec["fusion_only"] and finite) or camera:
        raise AssertionError(f"vovnet train: fusion_only {rec['fusion_only']}"
                             f", finite {finite}, camera trains {camera[:3]}")
    if any(rec["kernel_launches"].values()):
        raise AssertionError(f"vovnet train launched {rec['kernel_launches']}")
    if moved[0] + moved[4] != moved[1] or moved[2] != 0 or moved[0] == 0:
        raise AssertionError(f"vovnet train: moved {moved}")
    del state, start
    torch.cuda.empty_cache()


def msdeform_case(g, q: int, encoder: bool):
    """K7's inputs at the pillar slice's shapes: value [1, S, 8, 32];
    reference points (the queries' own cell centres for the encoder,
    random for the decoder) plus offsets over ±4 cells of each level for
    three points and ±48 for the fourth, whose vertical taps fall far
    outside any TPU band and, near the edges and on the small levels, off
    the map; softmaxed weights."""
    dev, heads, d, p = "cuda", 8, 32, 4
    l = len(BEV_LEVELS)
    s = sum(h * w for h, w in BEV_LEVELS)
    value = torch.randn(1, s, heads, d, device=dev, generator=g)
    if encoder:
        ref = torch.cat([torch.stack(torch.meshgrid(
            (torch.arange(w, device=dev) + 0.5) / w,
            (torch.arange(h, device=dev) + 0.5) / h, indexing="xy"),
            -1).reshape(-1, 2) for h, w in BEV_LEVELS])
    else:
        ref = torch.rand(q, 2, device=dev, generator=g)
    norm = torch.tensor([[w, h] for h, w in BEV_LEVELS], device=dev,
                        dtype=torch.float32)
    # points 0-2 within ±4 cells, point 3 within ±48
    reach = torch.tensor([4.0, 4.0, 4.0, 48.0], device=dev)[:, None]
    off = (torch.rand(1, q, heads, l, p, 2, device=dev, generator=g) * 2
           - 1) * reach
    loc = ref[None, :, None, None, None, :] + off / norm[:, None, :]
    wgt = torch.randn(1, q, heads, l * p, device=dev, generator=g)
    wgt = wgt.softmax(-1).reshape(1, q, heads, l, p)
    return value, loc, wgt


def phase_k7() -> dict:
    """K7 at one encoder and one decoder call of the pillar slice; per
    request (2 encoder + 6 decoder launches)."""
    from transcar_tpu_torch.ops import pallas_msdeform
    from transcar_tpu_torch.ops.msdeform import ms_deform_attn_core

    g = torch.Generator(device="cuda").manual_seed(13)
    res = _kernel_result()
    res["bound_by"] = "bytes"
    s = sum(h * w for h, w in BEV_LEVELS)
    for name, q, per_req, chunk in (("encoder", s, 2, 16384),
                                    ("decoder", 300, 6, 0)):
        value, loc, wgt = msdeform_case(g, q, name == "encoder")
        off_map = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
        out = pallas_msdeform.ms_deform_attn(value, BEV_LEVELS, loc, wgt)
        ref = ms_deform_attn_core(value, BEV_LEVELS, loc, wgt, chunk)
        torch.cuda.synchronize()
        err, rel = _rel_err(out, ref)
        ok = math.isfinite(rel) and rel <= MSDEFORM_TOL
        ms = cuda_ms(lambda: pallas_msdeform.ms_deform_attn(
            value, BEV_LEVELS, loc, wgt))
        plain_ms = cuda_ms(lambda: ms_deform_attn_core(
            value, BEV_LEVELS, loc, wgt, chunk), iters=5, warmup=1)
        # 4 taps (multiply-add each) and the weight (multiply-add) per
        # (query, head, sample, channel); of the value, no more than the
        # whole of it and no more than the 4 taps of every sample, which
        # is far less at a decoder call
        taps = wgt.numel() * 4 * value.shape[3] * value.element_size()
        bound, kind = bound_ms(10.0 * value.shape[3] * wgt.numel(),
                               torch.float32,
                               nbytes(loc, wgt, out)
                               + min(nbytes(value), taps))
        print(f"K7 msdeform {name} Q={q} S={s} 8 heads x 32, 4 levels x 4 "
              f"points: samples off the map {off_map:.3f}; max_abs_err "
              f"{err:.3e} max_rel_err {rel:.3e} (tol {MSDEFORM_TOL:.0e} of "
              f"max|plain|); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound:.4f} ms by {kind} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K7 {name} disagrees with its plain "
                                 f"version: rel err {rel}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ms"] += per_req * ms
        res["plain_ms"] += per_req * plain_ms
        res["bound_ms"] += per_req * bound
        if kind == "operations":
            res["bound_by"] = kind
        del value, loc, wgt, out, ref
    print(f"K7 per objdgcnn_pillar request (2 encoder + 6 decoder "
          f"launches): kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f}"
          f" ms, bound {res['bound_ms']:.4f} ms (no single PyTorch call "
          f"computes MSDeformAttn: F.grid_sample samples but does not reduce "
          f"with the weights)")
    return res


def phase_pillar(smi: str) -> int:
    """``objdgcnn_pillar`` batch-1 inference at full width."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.eval.decode import nms_free_decode
    from transcar_tpu_torch.models.dgcnn import MSDeformAttention

    preset = "objdgcnn_pillar"
    cfg = get_preset(preset)
    head = cfg.model.head
    per_req = 2 + head.num_decoder_layers                              # 8
    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    want = {k: 0 for k in rec["kernel_launches"]}
    want["msdeform_forward"] = per_req * rec["requests"]
    shape = (head.num_decoder_layers, 1, head.num_query, 10)
    finite = all(v.shape == shape and bool(torch.isfinite(v).all())
                 for v in out.values())
    dec = nms_free_decode(out, head)
    finite_dec = (dec["boxes"].shape == (1, head.max_detections, 9)
                  and bool(torch.isfinite(dec["boxes"]).all())
                  and bool(torch.isfinite(dec["scores"]).all()))
    print(f"pillar slice {preset} {rec['max_points']} points, 512x512 BEV bs1 "
          f"(bf16 SECOND and FPN, fp32 head, 300 queries): {rec['requests']}"
          f" requests, launches {rec['kernel_launches']} (want {want}); "
          f"outputs {shape} finite {finite}; decode finite {finite_dec}, "
          f"{int(dec['valid'].sum())}/{head.max_detections} valid boxes; "
          f"pillars {rec['pillar_audit']}")
    if rec["kernel_launches"] != want:
        raise AssertionError(f"pillar slice launches {rec['kernel_launches']}"
                             f" != {want}")
    if not (finite and finite_dec):
        raise AssertionError("pillar slice: non-finite outputs or decode")
    print(f"pillar slice bf16 kernel path: {rec['samples_per_sec']:.3f} "
          f"samples/s ({rec['ms_per_sample']:.2f} ms/sample), peak memory "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB on {smi}")

    # float32 BEV path and one decoder layer (the random-weight decoder
    # amplifies any difference): K7 (3 launches) against the plain version
    args = benchmark.parse_args([preset, "--cfg-options",
                                 "model.lidar_compute_dtype=float32",
                                 "model.head.num_decoder_layers=1"])
    _, model, batch, _ = benchmark._setup(args, training=False)
    outs = []
    with torch.inference_mode():
        for impl in ("pallas", "xla"):
            for mod in model.modules():
                if isinstance(mod, MSDeformAttention):
                    mod.impl = impl
            outs.append(model(batch["points"], batch["num_points"]))
    worst = max(((outs[0][k].double() - outs[1][k].double()).abs()
                 / (1 + outs[1][k].double().abs())).max().item()
                for k in outs[1])
    print(f"pillar slice fp32 (1 decoder layer) kernel path vs plain path: "
          f"max |diff|/(1+|plain|) {worst:.3e} (tol {SLICE_TOL:.0e}) "
          f"{'ok' if worst <= SLICE_TOL else 'FAIL'}")
    if not worst <= SLICE_TOL:
        raise AssertionError("fp32 pillar slice: kernel path disagrees with "
                             "plain")
    del model, outs
    torch.cuda.empty_cache()
    return rec["kernel_launches"]["msdeform_forward"]


def phase_k8_k9() -> tuple:
    """K8 and K9 at one encoder and one decoder call of the pillar slice,
    against the plain backward; per step (2 encoder + 6 decoder launches
    of each)."""
    from transcar_tpu_torch.ops import pallas_msdeform
    from transcar_tpu_torch.ops.msdeform import ms_deform_attn_backward

    g = torch.Generator(device="cuda").manual_seed(17)
    res = {"taps": _kernel_result(), "value": _kernel_result()}
    for r in res.values():
        r["bound_by"] = "bytes"
    s = sum(h * w for h, w in BEV_LEVELS)
    for name, q, per_step, chunk in (("encoder", s, 2, 16384),
                                     ("decoder", 300, 6, 0)):
        value, loc, wgt = msdeform_case(g, q, name == "encoder")
        d_out = torch.randn(1, q, value.shape[2] * value.shape[3],
                            device="cuda", generator=g)

        def taps():
            return pallas_msdeform.backward_taps_kernel(value, BEV_LEVELS,
                                                        loc, wgt, d_out)

        def dvalue():
            return pallas_msdeform.backward_value_kernel(value, BEV_LEVELS,
                                                         loc, wgt, d_out)

        def plain():
            return ms_deform_attn_backward(value, BEV_LEVELS, loc, wgt,
                                           d_out, chunk)

        d_loc, d_attn = taps()
        d_value = dvalue()
        ref_value, ref_loc, ref_attn = plain()
        torch.cuda.synchronize()
        errs = {k: _rel_err(a, b) for k, (a, b) in {
            "d_attn": (d_attn, ref_attn), "d_loc": (d_loc, ref_loc),
            "d_value": (d_value, ref_value)}.items()}
        ok = all(math.isfinite(rel) and rel <= MSDEFORM_BWD_TOL
                 for _, rel in errs.values())
        ms_taps, ms_value = cuda_ms(taps), cuda_ms(dvalue)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        # K8: the value (no more than the taps of every sample), the
        # locations, the weights and the gradient in, d_loc and d_attn out;
        # per (sample, channel) 7 operations for the sample, 5 for each of
        # its two derivatives and 3 multiply-adds.  K9: the locations, the
        # weights and the gradient in, d_value written once (at a decoder
        # call the zero-fill is that write: few cells meet a sample); per
        # (sample, channel) one product and 4 corner multiply-adds
        d = value.shape[3]
        taps_bytes = wgt.numel() * 4 * d * value.element_size()
        b_taps, k_taps = bound_ms(
            23.0 * d * wgt.numel(), torch.float32,
            nbytes(loc, wgt, d_out, d_loc, d_attn)
            + min(nbytes(value), taps_bytes))
        b_value, k_value = bound_ms(
            9.0 * d * wgt.numel(), torch.float32,
            nbytes(loc, wgt, d_out, d_value))
        print(f"K8/K9 msdeform backward {name} Q={q} S={s} 8 heads x 32, 4 "
              f"levels x 4 points: "
              + ", ".join(f"{k} max_abs_err {e:.3e} rel {r:.3e}"
                          for k, (e, r) in errs.items())
              + f" (tol {MSDEFORM_BWD_TOL:.0e} of max|plain|); K8 "
              f"{ms_taps:.4f} ms (bound {b_taps:.4f} ms by {k_taps}), K9 "
              f"{ms_value:.4f} ms (bound {b_value:.4f} ms by {k_value}), "
              f"plain backward (all three gradients) {plain_ms:.3f} ms "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K8/K9 {name} disagree with the plain "
                                 f"backward: {errs}")
        for key, ms, bound, kind, err in (
                ("taps", ms_taps, b_taps, k_taps,
                 max(errs["d_attn"][0], errs["d_loc"][0])),
                ("value", ms_value, b_value, k_value, errs["d_value"][0])):
            r = res[key]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"] += per_step * ms
            r["plain_ms"] += per_step * plain_ms
            r["bound_ms"] += per_step * bound
            if kind == "operations":
                r["bound_by"] = kind
        del value, loc, wgt, d_out, d_loc, d_attn, d_value
        del ref_value, ref_loc, ref_attn
        torch.cuda.empty_cache()
    print(f"K8 / K9 per objdgcnn_pillar train step (2 encoder + 6 decoder "
          f"launches each): K8 {res['taps']['ms']:.3f} ms (bound "
          f"{res['taps']['bound_ms']:.4f} ms), K9 {res['value']['ms']:.3f} "
          f"ms (bound {res['value']['bound_ms']:.4f} ms); the plain backward"
          f" computes all three gradients in one pass, "
          f"{res['taps']['plain_ms']:.3f} ms, and stands in both rows (no "
          f"single PyTorch call computes the MSDeformAttn backward)")
    return res["taps"], res["value"]


def phase_pillar_train(smi: str) -> dict:
    """``objdgcnn_pillar`` training at full width through ``benchmark
    --train``."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.ops import pallas_msdeform

    preset = "objdgcnn_pillar"
    per_step = 2 + get_preset(preset).model.head.num_decoder_layers     # 8
    params0, buffers0 = _initial_state(preset)
    _zero_counts()
    rec, state = benchmark.run_train([preset, "--train", "--samples", "5",
                                      "--warmup", "2"])
    counts = (pallas_msdeform.launches,
              pallas_msdeform.backward_taps_launches,
              pallas_msdeform.backward_value_launches)
    steps = rec["steps"]
    want = {k: 0 for k in rec["kernel_launches"]}
    for k in ("msdeform_forward", "msdeform_backward_taps",
              "msdeform_backward_value"):
        want[k] = per_step * steps
    moved = total = 0
    for name, p in state.model.named_parameters():
        moved += int((p.detach() != params0[name]).sum())
        total += p.numel()
    bufs_moved = sum(int(not torch.equal(b, buffers0[n]))
                     for n, b in state.model.named_buffers())
    n_bufs = len(buffers0)
    finite = all(math.isfinite(v) for r in (rec["loss_first"],
                                            rec["loss_last"])
                 for v in r.values())
    print(f"pillar train {preset} {rec['max_points']} points, 512x512 BEV "
          f"bs1 (bf16 SECOND and FPN, fp32 head, dropout 0.1, batch "
          f"statistics): {steps} steps, launches {rec['kernel_launches']} "
          f"(want {want}: K7, K8, K9 {per_step} per step); loss total first "
          f"{rec['loss_first']['total']:.4f} last "
          f"{rec['loss_last']['total']:.4f}, finite {finite}; trainable "
          f"elements moved {moved}/{total} ({moved / total:.4f}); BN "
          f"running statistics moved {bufs_moved}/{n_bufs}; peak memory "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"{rec['ms_per_step']:.2f} ms/step, {rec['steps_per_sec']:.3f} "
          f"steps/s on {smi}")
    if rec["kernel_launches"] != want or counts != (per_step * steps,) * 3:
        raise AssertionError(f"pillar train launches {rec['kernel_launches']}"
                             f" / {counts} != {want}")
    if not finite:
        raise AssertionError("pillar train: non-finite loss")
    if moved <= 0.9 * total or bufs_moved != n_bufs:
        raise AssertionError(f"pillar train: moved {moved}/{total} elements,"
                             f" {bufs_moved}/{n_bufs} BN statistics")
    launches = rec["kernel_launches"]
    del state, params0, buffers0
    torch.cuda.empty_cache()
    return launches


def phase_pillar_train_check() -> None:
    """One float32 step of ``objdgcnn_pillar`` (float32 BEV, one decoder
    layer, dropout 0, batch statistics), the kernel path (K7, K8, K9)
    against the plain path (``impl = "xla"`` on every MSDeformAttention),
    from the same weights and batch, with cuDNN held deterministic so
    that the BEV backward is the same on both."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.models.dgcnn import MSDeformAttention
    from transcar_tpu_torch.ops import pallas_msdeform
    from transcar_tpu_torch.train.step import compute_losses, init_state

    args = benchmark.parse_args([
        "objdgcnn_pillar", "--train", "--dropout", "0", "--cfg-options",
        "model.lidar_compute_dtype=float32",
        "model.head.num_decoder_layers=1"])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for impl in ("pallas", "xla"):
            cfg, model, batch, _ = benchmark._setup(args, training=True)
            for mod in model.modules():
                if isinstance(mod, MSDeformAttention):
                    mod.impl = impl
            state = init_state(cfg, model, total_steps=1)
            _zero_counts()
            losses = compute_losses(state, batch)
            losses["total"].backward()
            torch.cuda.synchronize()
            counts = (pallas_msdeform.launches,
                      pallas_msdeform.backward_taps_launches,
                      pallas_msdeform.backward_value_launches)
            runs.append(({k: v.item() for k, v in losses.items()},
                         {n: p.grad.detach().clone() for n, p in
                          model.named_parameters() if p.grad is not None},
                         {n: b.detach().clone() for n, b in
                          model.named_buffers()}, counts))
            del state, model, losses
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    (lk, gk, bk, ck), (lp, gp, bp, cp) = runs
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    worst_name, worst = "", 0.0
    for name, ref in gp.items():
        err = ((gk[name] - ref).abs().max()
               / ref.abs().max().clamp(min=1e-30)).item()
        if not err <= worst:
            worst_name, worst = name, err
    stats = max(((bk[n] - b).abs().max() / b.abs().max().clamp(min=1e-30))
                .item() for n, b in bp.items())
    ok = (gk.keys() == gp.keys() and loss_err <= STEP_TOL
          and worst <= PILLAR_GRAD_TOL and ck == (3, 3, 3) and cp == (0,) * 3)
    print(f"pillar train check fp32 (1 decoder layer, dropout 0), kernel vs "
          f"plain, one step: launches kernel {ck} plain {cp}; loss rel err "
          f"{loss_err:.3e} (tol {STEP_TOL:.0e}); gradients of {len(gp)} "
          f"leaves, worst max|diff|/max|plain| {worst:.3e} at {worst_name} "
          f"(tol {PILLAR_GRAD_TOL:.0e}); BN running statistics rel diff "
          f"{stats:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pillar train check: kernel path disagrees "
                             "with the plain path")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", default=None,
                    help="an earlier commit's transcar_tpu_torch/csrc: build "
                         "it too and time its K3 and K4 in turns with "
                         "these (phases K3, K4)")
    args = ap.parse_args(argv)
    smi = phase_device()
    phase_build()
    parent = parent_library(args.parent_csrc) if args.parent_csrc else None
    k1 = phase_k1()
    k3 = phase_k3(parent)
    k2 = phase_k2()
    launches = phase_slice(smi)
    train = phase_train(smi)
    phase_train_check()
    launches["dcn_backward"] = train["detr3d_r101"]["launches"][1]
    k4 = phase_k4(parent)
    k5 = phase_k5()
    k6 = phase_k6()
    launches["osa_reduce"] = phase_vovnet_slice(smi)["osa_reduce"]
    launches["osa_block"] = phase_k5_path(smi)
    launches["bottleneck"] = phase_k6_path(smi)
    phase_vovnet_train(smi)
    k7 = phase_k7()
    launches["msdeform_forward"] = phase_pillar(smi)
    k8, k9 = phase_k8_k9()
    train_launches = phase_pillar_train(smi)
    phase_pillar_train_check()
    phase_sync()
    for name in ("msdeform_backward_taps", "msdeform_backward_value"):
        launches[name] = train_launches[name]
    kernels = []
    for name, res, source, replaces in (
            ("dcn_forward", k1, "transcar_tpu_torch/csrc/dcn_forward.cu",
             "transcar_tpu/ops/pallas_dcn.py:174"),
            ("masked_attention", k2,
             "transcar_tpu_torch/csrc/masked_attention.cu",
             "transcar_tpu/ops/pallas_attention.py:60"),
            ("dcn_backward", k3, "transcar_tpu_torch/csrc/dcn_backward.cu",
             "transcar_tpu/ops/pallas_dcn.py:387"),
            ("osa_reduce", k4, "transcar_tpu_torch/csrc/osa_reduce.cu",
             "transcar_tpu/ops/pallas_osa.py:67"),
            ("osa_block", k5, "transcar_tpu_torch/csrc/osa_block.cu",
             "transcar_tpu/ops/pallas_osa_block.py:115"),
            ("bottleneck", k6, "transcar_tpu_torch/csrc/bottleneck.cu",
             "transcar_tpu/ops/pallas_bottleneck.py:118"),
            ("msdeform_forward", k7,
             "transcar_tpu_torch/csrc/msdeform_forward.cu",
             "transcar_tpu/ops/pallas_msdeform.py:453"),
            ("msdeform_backward_taps", k8,
             "transcar_tpu_torch/csrc/msdeform_backward.cu",
             "transcar_tpu/ops/pallas_msdeform.py:529"),
            ("msdeform_backward_value", k9,
             "transcar_tpu_torch/csrc/msdeform_backward.cu",
             "transcar_tpu/ops/pallas_msdeform.py:592")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"],
                        "bound_ms": res["bound_ms"],
                        "bound_by": res["bound_by"],
                        "library_ms": res["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
