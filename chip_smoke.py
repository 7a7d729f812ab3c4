"""Smoke test of the PyTorch/CUDA port (``transcar_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the script exits
non-zero):

  1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from ``transcar_tpu_torch/csrc`` (seconds taken);
  3. K1 (DCNv2 forward) against its plain version at both flagship DCN
     shapes, bfloat16 and float32, offsets drawn over ±8 px;
  4. K3 (DCNv2 backward) against autograd of its plain version at both
     flagship DCN shapes, bfloat16 and float32, offsets over ±8 px, zero
     and whole-pixel;
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
     kernel path against plain path (see phase_train_check).

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  There is no CPU path: without CUDA the
script raises.
"""
from __future__ import annotations

import json
import math
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
# Published dense peaks of one H100 SXM at 700 W (FLOP/s) and its memory
# rate (bytes/s), for the bound of each kernel's work
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
ATTN_TOL = 2e-4          # as tests/test_pallas_attention.py
SLICE_TOL = 1e-3         # float32 slice, kernel path vs plain path
# float32 train step, kernel path vs plain path: loss and gradient norm
# differ by summation order (the d_x / d_W atomics, the DCN GEMMs); the
# parameters after one AdamW step agree to 1e-2·lr in all but a few
# elements whose gradient is at rounding noise, where Adam's g / (|g| +
# eps) may step either way: those stay within 2·lr
STEP_TOL = 1e-4
PARAM_TIGHT, PARAM_SHARE = 1e-2, 0.999


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
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: {so.relative_to(kernel_lib.PACKAGE.parent)} from "
          f"{sorted(p.name for p in kernel_lib.CSRC.glob('*.cu'))} in "
          f"{dt:.1f} s ({'compiled' if fresh else 'cached'}); ptxas: "
          + " | ".join(ptxas))


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
    whole-pixel offsets in [-3, 3]."""
    dev = "cuda"
    x = torch.randn(n, h, w, cin, device=dev, generator=g).to(dtype)
    om = torch.randn(n, h, w, 27, device=dev, generator=g)
    if offsets == "pm8":
        om[..., :18] = torch.rand(n, h, w, 18, device=dev, generator=g) * 16 - 8
    elif offsets == "zero":
        om[..., :18] = 0.0
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


def phase_k3() -> dict:
    from transcar_tpu_torch.ops import pallas_dcn

    g = torch.Generator(device="cuda").manual_seed(3)
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bound_by": "operations", "library_ms": None}
    for dtype in (torch.bfloat16, torch.float32):
        for n, h, w, cin, cout, per_step in FLAGSHIP_DCN:
            for offsets in ("pm8", "zero", "integer"):
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
                if offsets == "pm8":
                    ms = cuda_ms(lambda: pallas_dcn.backward_kernel(
                        x, om, wt, d_out))
                    plain_ms = cuda_ms(lambda: pallas_dcn.plain_backward(
                        x, om, wt, d_out), iters=5, warmup=1)
                    line += f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                    if dtype == torch.bfloat16:
                        result["max_abs_err"] = max(result["max_abs_err"], err)
                        result["ms"] += per_step * ms
                        result["plain_ms"] += per_step * plain_ms
                        result["bound_ms"] += per_step * dcn_bound_ms(
                            x, om, wt, d_out, backward=True)
                print(line + (" ok" if ok else " FAIL"))
                if not ok:
                    raise AssertionError(f"K3 {dtype} {offsets} disagrees "
                                         f"with its plain version: {rels}")
                del x, om, wt, d_out
    print(f"K3 per detr3d_r101 train step on the bfloat16 path (23 + 3 "
          f"launches): kernel {result['ms']:.3f} ms, plain "
          f"{result['plain_ms']:.3f} ms, bound {result['bound_ms']:.3f} ms "
          f"(no single PyTorch call computes the DCNv2 backward)")
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
    from transcar_tpu_torch.eval.decode import nms_free_decode
    from transcar_tpu_torch.models.resnet import RESNET_DEPTHS
    from transcar_tpu_torch.ops import pallas_attention, pallas_dcn

    preset = "transcar_r101"
    cfg = get_preset(preset)
    depths = RESNET_DEPTHS[int(cfg.model.backbone.kind[6:])]
    per_req = (sum(d for d, dcn in zip(depths, cfg.model.backbone.with_dcn)
                   if dcn), cfg.model.head.num_fusion_layers)     # (26, 3)
    plain = ["model.backbone.dcn_impl=exact",
             "model.head.use_pallas_attention=false"]

    # the main path: bfloat16 backbone, float32 head, through the kernels
    pallas_dcn.launches = pallas_attention.launches = 0
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    launches = (pallas_dcn.launches, pallas_attention.launches)
    want = tuple(n * rec["requests"] for n in per_req)
    for key, val in out.items():
        if val.shape != (per_req[1], 1, 900, 10) or not torch.isfinite(val).all():
            raise AssertionError(f"slice {key}: shape {tuple(val.shape)}, "
                                 f"finite {bool(torch.isfinite(val).all())}")
    dec = nms_free_decode(out, cfg.model.head)
    if dec["boxes"].shape != (1, 300, 9) or not torch.isfinite(dec["boxes"]).all():
        raise AssertionError("decode: bad boxes")
    print(f"slice {preset} 6x928x1600 bs1 (bf16 backbone, fp32 head): "
          f"{rec['requests']} requests, launches K1 {launches[0]} K2 "
          f"{launches[1]} (want {want[0]}, {want[1]}: {per_req[0]} + "
          f"{per_req[1]} per request); outputs finite; decode "
          f"{int(dec['valid'].sum())}/300 valid boxes; DCN taps with "
          f"|dy|>5 px {rec['dcn_taps_past_5px']:.4f}; fusion keeps "
          f"{rec['fusion_keep_share']:.3e} of (query, token) pairs")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")

    # float32 backbone: the kernel path against the plain path.  The
    # random-weight decoder amplifies any perturbation about 10x per layer
    # (measured on an H100: FPN levels agree to 4e-6, the six decoder
    # layers' outputs then to 2e-6, 1e-4, 1e-3, 2e-2, 0.14 and 1.05), so
    # this check keeps one decoder layer: full backbone and FPN (26 K1
    # launches), one decoder layer, the 3 fusion layers (3 K2 launches).
    f32 = [preset, "--samples", "1", "--warmup", "0", "--cfg-options",
           "model.backbone.compute_dtype=float32",
           "model.head.num_decoder_layers=1"]
    _, k32 = benchmark.run(f32)
    _, p32 = benchmark.run(f32 + plain)
    worst = 0.0
    for key in k32:
        a, b = k32[key].double(), p32[key].double()
        worst = max(worst, ((a - b).abs() / (1 + b.abs())).max().item())
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
    return {"dcn_forward": launches[0], "masked_attention": launches[1]}


def _initial_params(preset: str, cfg_options=()) -> dict:
    """The parameters ``benchmark --train`` starts from (same seed, same
    randomized DCN offsets), on the card."""
    from transcar_tpu_torch.cli import benchmark

    args = benchmark.parse_args([preset, "--train", "--cfg-options",
                                 *cfg_options])
    _, model, _, _ = benchmark._setup(args, training=True)
    return {n: p.detach() for n, p in model.named_parameters()}


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
        start = _initial_params(preset)
        # this recipe's path, counts at 0 just before and read just after
        pallas_dcn.launches = pallas_dcn.backward_launches = 0
        pallas_attention.launches = 0
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
            start = _initial_params(preset, opts + extra)
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


def main() -> None:
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    k3 = phase_k3()
    k2 = phase_k2()
    launches = phase_slice(smi)
    train = phase_train(smi)
    phase_train_check()
    launches["dcn_backward"] = train["detr3d_r101"]["launches"][1]
    kernels = []
    for name, res, source, replaces in (
            ("dcn_forward", k1, "transcar_tpu_torch/csrc/dcn_forward.cu",
             "transcar_tpu/ops/pallas_dcn.py:174"),
            ("masked_attention", k2,
             "transcar_tpu_torch/csrc/masked_attention.cu",
             "transcar_tpu/ops/pallas_attention.py:60"),
            ("dcn_backward", k3, "transcar_tpu_torch/csrc/dcn_backward.cu",
             "transcar_tpu/ops/pallas_dcn.py:387")):
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
