"""Smoke test of the PyTorch/CUDA port (``transcar_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the script exits
non-zero):

  1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from ``transcar_tpu_torch/csrc`` (seconds taken);
  3. K1 (DCNv2 forward) against its plain version at both flagship DCN
     shapes, bfloat16 and float32, offsets drawn over ±8 px;
  4. K2 (masked attention core) against its plain version at 900 × 1500,
     8 heads of 32;
  5. the flagship slice through ``transcar_tpu_torch.cli.benchmark``:
     TransCAR-R101 batch-1 inference on 6 × 928 × 1600 with 900 queries
     and 1500 radar tokens, seeded random weights; launch counts, finite
     outputs, kernel path against plain path in float32 (one decoder
     layer, see phase_slice), samples/s of the kernel and the plain path
     in bfloat16.

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
ATTN_TOL = 2e-4          # as tests/test_pallas_attention.py
SLICE_TOL = 1e-3         # float32 slice, kernel path vs plain path


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
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
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
            del x, om, wt, out, ref
            if dtype == torch.bfloat16:     # the main path's dtype
                result["max_abs_err"] = max(result["max_abs_err"], err)
                result["ms"] += per_req * ms
                result["plain_ms"] += per_req * plain_ms
    print(f"K1 per request on the bfloat16 path (23 + 3 launches): kernel "
          f"{result['ms']:.3f} ms, plain {result['plain_ms']:.3f} ms")
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
    ok = finite and err <= ATTN_TOL
    print(f"K2 attention [{b}x{heads}, {nq}x{t}, hd {hd}] keep density "
          f"{keep.float().mean().item():.3f}, gated rows "
          f"{int(gate.sum())}/{nq}: max_abs_err {err:.3e} max_rel_err "
          f"{rel:.3e} (tol {ATTN_TOL:.0e}), all finite {finite}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K2 disagrees with its plain version")
    return {"max_abs_err": err, "ms": 3 * ms, "plain_ms": 3 * plain_ms}


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


def main() -> None:
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    launches = phase_slice(smi)
    kernels = []
    for name, res, source, replaces in (
            ("dcn_forward", k1, "transcar_tpu_torch/csrc/dcn_forward.cu",
             "transcar_tpu/ops/pallas_dcn.py:174"),
            ("masked_attention", k2,
             "transcar_tpu_torch/csrc/masked_attention.cu",
             "transcar_tpu/ops/pallas_attention.py:60")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
