"""Smoke test of the PyTorch/CUDA port (``transcar_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

``--parent-csrc DIR`` also builds an earlier commit's kernel sources (for
example ``git archive <commit> transcar_tpu_torch/csrc`` unpacked under
the git-ignored ``transcar_tpu_torch/build/``) and times its K1, K3, K2,
K4, K5, K6, K7, K8 and K9 in turns with these (parent, kernel, kernel,
parent) in phases 3, 4, 5, 8, 13 and 15; the summary line then carries
each one's ``parent_ms``.  ``--variants k1|k2|k5|k6|k7|k8|k9|all`` runs
none of the phases: it builds each knock-out variant of the K1 / K2 / K5
/ K6 / K7 / K8 / K9 kernels in ``VARIANTS`` (a copy of their sources
under ``transcar_tpu_torch/build/variants/`` with its patches) and prints
its time per request or step at the main path's shapes (and K2's error
against its plain version).

Phases, one line each (a failing phase raises and the script exits
non-zero):

  1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from ``transcar_tpu_torch/csrc`` (seconds taken);
  3. K1 (DCNv2 forward) against its plain version at both flagship DCN
     shapes, bfloat16 (on the Hopper tile) and float32 (on the first
     tile), offsets over ±8 px, zero and whole-pixel, and in bfloat16 at
     the model's offset scale; per request beside cuDNN's bf16 3×3 conv of
     the same shapes (the GEMM without the gather, a reference line); the
     Hopper tile's ``-Xptxas -v`` line;
  4. K3 (DCNv2 backward) against autograd of its plain version at both
     flagship DCN shapes, bfloat16 and float32, offsets over ±8 px, zero
     and whole-pixel, and in bfloat16 at the model's offset scale; its two
     device kernels, (a) d_x + d_om and (b) d_W, timed apart;
  5. K2 (masked attention core) against its plain version at 900 × 1500,
     8 heads of 32, at batch 1 and 4 on the ``split_heads`` views of the
     main path, every row (fully masked ones too), on the tensor-core
     kernel; per request (3 launches, queued back to back) beside
     ``F.scaled_dot_product_attention``, its bound as three TF32 products
     and as float32 FMAs, and the parent's K2 with its error;
  6. the flagship slice through ``transcar_tpu_torch.cli.benchmark``:
     TransCAR-R101 batch-1 inference on 6 × 928 × 1600 with 900 queries
     and 1500 radar tokens, seeded random weights; launch counts (every K1
     launch on the Hopper tile, every K2 launch on the tensor-core
     kernel), finite
     outputs, kernel path against plain path in float32 (one decoder
     layer, see phase_slice), samples/s of the kernel and the plain path
     in bfloat16;
  7. training through ``benchmark --train`` at the same width: the
     ``detr3d_r101`` full-backbone recipe (K1 forward, K3 backward) and
     the ``transcar_r101`` fusion-only recipe (K1 only), bfloat16
     backbone; finite losses, launch counts per step (every K1 launch on
     the Hopper tile), which parameters
     moved, peak memory, ms/step; then one float32 step of each recipe,
     kernel path against plain path (see phase_train_check);
  8. K4 (OSA concat-reduce), K5 (whole OSA block) and K6 (fused
     bottleneck) against their plain versions at every distinct flagship
     shape (the 7 VoVNet-99 block shapes, the 3 R101 stride-1 non-DCN
     bottleneck shapes), bfloat16 and float32; K4 beside a cuDNN 1×1
     ``F.conv2d`` over the concatenation built beforehand, every bfloat16
     call on the Hopper (wgmma) tile and every float32 one on the wmma
     tile of ``conv_tile.cuh``; K5 in bfloat16 as 5 chain-tile launches
     and one K4 Hopper-tile launch per call, timed apart, beside the
     default path's cost for the same blocks (cuDNN bf16 3×3 chain, then
     K4); K6 in bfloat16 on the Hopper tile with its three device kernels
     timed apart, beside cuDNN's bf16 convolutions of the same shapes (a
     reference line), and the K6 tile's ``-Xptxas -v`` lines;
  9. the VoVNet-99 slice through ``benchmark transcar_vovnet_trainval``:
     16 K4 + 3 K2 + 0 K1 launches per request, every K4 launch on the
     wgmma tile and every K2 launch on the tensor-core kernel, finite
     outputs and decode,
     float32 kernel path against plain path (one decoder layer),
     samples/s and peak memory of the kernel and the plain path in
     bfloat16;
 10. the K5 path: the full-width VoVNet-99 backbone with
     ``stage_impls=("fused",) * 4`` (16 K5 launches; in bfloat16 80
     chain-tile launches and 16 reduces on K4's Hopper tile) against the K4
     default on the 4 stage outputs, float32, and both timed in bfloat16;
 11. the K6 path: ``benchmark transcar_r101 --cfg-options
     model.backbone.block_impl=fused``: 6 K6 + 26 K1 (all on their
     Hopper tiles) + 3 K2 per request,
     float32 against the plain path, samples/s beside the default path;
 12. one ``transcar_vovnet_trainval --train`` fusion-only run: finite
     loss, camera frozen, no kernel launches (training takes the plain
     OSA tail, as in JAX), ms/step and peak memory;
 13. K7 (multi-scale deformable attention) against its plain version at
     the ObjDGCNN pillar shapes: one encoder call (87 040 queries over the
     256² / 128² / 64² / 32² BEV levels) and one decoder call (300
     queries), 8 heads of 32, 4 levels × 4 points, offsets up to ±48
     cells (far past any TPU band, and off the map), softmaxed weights;
     each call on the lane-group kernel, compared bit for bit with the
     first kernel (and the parent's K7); the lane-group kernel's
     ``-Xptxas -v`` line;
 14. the ObjDGCNN pillar slice through ``benchmark objdgcnn_pillar``:
     300 000 points, 512² BEV, bfloat16 SECOND and FPN, float32 head, 300
     queries; 8 K7 launches per request (all on the lane-group kernel)
     and no other kernel, finite outputs and decode, samples/s and peak
     memory, then float32 with one decoder layer, kernel path against
     plain path;
 15. K8 (d_attn, d_loc) and K9 (d_value), the MSDeformAttn backward,
     against the plain backward (autograd of K7's plain version, chunked)
     at one encoder and one decoder call of the pillar shapes, with K7's
     inputs and a random output gradient, K8 and K9 on their lane-group
     kernels; per call and per step, and the lane-group kernels'
     ``-Xptxas -v`` lines;
 16. ``objdgcnn_pillar`` training through ``benchmark --train`` at the
     same width (dropout 0.1, batch statistics, clip 35, AdamW with the
     VFE and SECOND at lr × 0.1): 8 K7 + 8 K8 + 8 K9 launches per step
     (all on the lane-group kernels) and no other kernel, finite losses, trainable elements and BN running
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
TF32_FLOPS = 495e12     # dense TF32 on the tensor cores
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


def csrc_library(csrc, tag: str):
    """The kernel library built from the sources in ``csrc`` into the
    git-ignored ``transcar_tpu_torch/build/<tag>``, opened with ctypes."""
    from transcar_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    so = kernel_lib.build(pathlib.Path(csrc).resolve(),
                          kernel_lib.BUILD_DIR / tag)
    print(f"build {tag}: {so.name} from {csrc} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ctypes.CDLL(str(so))


def parent_library(csrc: str):
    """The kernel library built from an earlier commit's ``csrc`` (for
    example ``git archive <parent> transcar_tpu_torch/csrc`` unpacked
    under the git-ignored ``transcar_tpu_torch/build/``), to time its
    kernels beside these in the same run."""
    return csrc_library(csrc, "parent")


# Knock-out variants of the K1, K2, K5, K6, K7, K8 and K9 kernels
# (``--variants``):
# name: (sources copied, [(file patched, old text, new text), ...]).  A
# variant that takes out part of the work computes garbage; only its time
# is read.  A patch whose old text is gone raises.  No patch may drop an
# mbarrier wait: a gather that skips its wait on ``empty`` over-arrives the
# ring.
K1_SRC = ("dcn_forward.cu", "dcn_tap.cuh", "hopper_tile.cuh")
K5_SRC = ("osa_block.cu", "osa_wgmma.cuh", "hopper_tile.cuh", "conv_tile.cuh")
K6_SRC = ("bottleneck.cu", "osa_wgmma.cuh", "hopper_tile.cuh", "conv_tile.cuh")
K7_SRC = ("msdeform_forward.cu", "msdeform_gather.cuh")
K8_SRC = ("msdeform_backward.cu", "msdeform_gather.cuh")
K9_SRC = K8_SRC
K2_SRC = ("masked_attention.cu", "hopper_tile.cuh")
# the lane-group gather of K7 and K8 with its corner loads replaced by
# register values that depend on the sample
_NO_VALUE_LOADS = (
    "msdeform_gather.cuh",
    "    t[0][k] = in && c.v00 ? __ldg(reinterpret_cast<const float4*>(p + t00)) : zero;\n"
    "    t[1][k] = in && c.v01 ? __ldg(reinterpret_cast<const float4*>(p + t00 + row)) : zero;\n"
    "    t[2][k] = in && c.v10 ? __ldg(reinterpret_cast<const float4*>(p + t10)) : zero;\n"
    "    t[3][k] = in && c.v11 ? __ldg(reinterpret_cast<const float4*>(p + t10 + row)) : zero;\n",
    "    for (int q = 0; q < 4; ++q)\n"
    "      t[q][k] = in ? make_float4(c.tx + q, c.ty, c.tx, c.ty + q) : zero;\n")
# K9's vector atomic add, and what the knock-outs put in its place
_RED_ADD4 = "  atomicAdd(reinterpret_cast<float4*>(p), v);\n"
_K6_BN64 = (
    "  if (bn == 64) return osa::launch_tile<64>(bottleneck_{}_wgmma_kernel<64{}>, p,"
    " stream);\n  return bn == 256\n")
VARIANTS = {
    "k2 base": (K2_SRC, []),
    "k2 one-pass TF32 (hi.hi only)": (K2_SRC, [
        ("masked_attention.cu", "  lo = tf32(x - __uint_as_float(hi));\n",
         "  lo = 0u;\n"),
        ("masked_attention.cu", "    klo[swz(rk, c)] = lo;\n", ""),
        ("masked_attention.cu", "    vlo[swz(rv, 2 * j + h)] = lo;\n", ""),
        ("masked_attention.cu",
         "    wgmma_ss(s, hop::desc_add(dql, off), hop::desc_add(dkh, off), kk > 0);\n"
         "    wgmma_ss(s, hop::desc_add(dqh, off), hop::desc_add(dkl, off), 1);\n"
         "    wgmma_ss(s, hop::desc_add(dqh, off), hop::desc_add(dkh, off), 1);\n",
         "    wgmma_ss(s, hop::desc_add(dqh, off), hop::desc_add(dkh, off), kk > 0);\n"),
        ("masked_attention.cu",
         "    wgmma_rs(os, al[j], hop::desc_add(dvh, off), j > 0);\n"
         "    wgmma_rs(os, ah[j], hop::desc_add(dvl, off), 1);\n"
         "    wgmma_rs(os, ah[j], hop::desc_add(dvh, off), 1);\n",
         "    wgmma_rs(os, ah[j], hop::desc_add(dvh, off), j > 0);\n")]),
    "k2 P V summed into O over all tokens (no chunk sums)": (K2_SRC, [
        ("masked_attention.cu",
         "  float os[4][4] = {};             // this chunk's P V\n",
         "  float os[4][4];\n#pragma unroll\n  for (int n = 0; n < 4; ++n)\n"
         "#pragma unroll\n    for (int i = 0; i < 4; ++i) os[n][i] = o[n][i] * alpha[i >> 1];\n"),
        ("masked_attention.cu",
         "    wgmma_rs(os, al[j], hop::desc_add(dvh, off), j > 0);\n",
         "    wgmma_rs(os, al[j], hop::desc_add(dvh, off), 1);\n"),
        ("masked_attention.cu",
         "      o[n][i] = fmaf(o[n][i], alpha[i >> 1], os[n][i]);\n",
         "      o[n][i] = os[n][i];\n")]),
    "k2 Q, K and V tiles not split (raw bits as TF32; numerics off)": (K2_SRC, [(
        "masked_attention.cu",
        "  for (int i = 0; i < 4; ++i) split(x[i], h[i], l[i]);\n",
        "  for (int i = 0; i < 4; ++i) h[i] = l[i] = __float_as_uint(x[i]);\n")]),
    "k2 no token split (one warpgroup a block)": (K2_SRC, [(
        "masked_attention.cu", "constexpr int TW = 4;",
        "constexpr int TW = 1;")]),
    "k2 two token warpgroups a block": (K2_SRC, [(
        "masked_attention.cu", "constexpr int TW = 4;",
        "constexpr int TW = 2;")]),
    "k2 three token warpgroups a block": (K2_SRC, [(
        "masked_attention.cu", "constexpr int TW = 4;",
        "constexpr int TW = 3;")]),
    "k2 2-stage rings": (K2_SRC, [(
        "masked_attention.cu", "constexpr int NS = 3;",
        "constexpr int NS = 2;")]),
    "k2 synchronous staging (no ring)": (K2_SRC, [(
        "masked_attention.cu",
        "#pragma unroll\n  for (int s = 0; s < NS - 1; ++s) {\n"
        "    if (s < mine) issue_chunk(p, ring, kb, vb, mb, q0, th + TW * s, s, tid);\n"
        "    cp_async_commit();\n  }\n", ""), (
        "masked_attention.cu",
        "    cp_async_wait<NS - 2>();\n"
        "    wg_sync(th);                  // chunk s landed; slot (s - 1) % NS free\n"
        "    if (s + NS - 1 < mine)\n"
        "      issue_chunk(p, ring, kb, vb, mb, q0, ci + TW * (NS - 1), s + NS - 1,\n"
        "                  tid);\n"
        "    cp_async_commit();\n",
        "    wg_sync(th);                  // every warp done with the slot\n"
        "    issue_chunk(p, ring, kb, vb, mb, q0, ci, s, tid);\n"
        "    cp_async_commit();\n"
        "    cp_async_wait<0>();\n"
        "    wg_sync(th);\n")]),
    "k2 no split pass (tiles left stale)": (K2_SRC, [(
        "masked_attention.cu", "    split_chunk(st, tiles, tid);\n", "")]),
    "k2 no S products": (K2_SRC, [(
        "masked_attention.cu", "wgmma_ss(s, ", "if (p.T < 0) wgmma_ss(s, ")]),
    "k2 no P V products": (K2_SRC, [(
        "masked_attention.cu", "wgmma_rs(os, ", "if (p.T < 0) wgmma_rs(os, ")]),
    "k2 no loads (rings never filled)": (K2_SRC, [
        ("masked_attention.cu",
         "    if (s < mine) issue_chunk(p, ring, kb, vb, mb, q0, th + TW * s, s, tid);\n",
         ""),
        ("masked_attention.cu",
         "      issue_chunk(p, ring, kb, vb, mb, q0, ci + TW * (NS - 1), s + NS - 1,\n"
         "                  tid);\n", "      ;\n")]),
    "k2 products only (no mask, no softmax)": (K2_SRC, [(
        "masked_attention.cu",
        "  softmax_chunk(p, ms, tok_w, qw, g, t, s, m, l, alpha);\n", "")]),
    "k1 base": (K1_SRC, []),
    "k1 3-stage ring": (K1_SRC, [(
        "dcn_forward.cu", "constexpr int F_STAGES = 2;", "constexpr int F_STAGES = 3;")]),
    "k1 8x16 tiles": (K1_SRC, [(
        "dcn_forward.cu", "  pick_tile(p, sms);",
        "  pick_tile(p, sms);\n  p.bh = 8; p.bw = 16; p.tiles_h = (H + 7) / 8;"
        " p.tiles_w = (W + 15) / 16;\n"
        "  p.tiles = N * p.tiles_h * p.tiles_w * p.tiles_n;")]),
    "k1 taps outer (K order tap, then channel slice)": (K1_SRC, [(
        "dcn_forward.cu",
        "      for (int c = 0; c < p.cs; ++c) {\n        for (int k = 0; k < 9; ++k) {",
        "      for (int k = 0; k < 9; ++k) {\n        for (int c = 0; c < p.cs; ++c) {")]),
    "k1 all shared memory carved out (small L1)": (K1_SRC, [(
        "dcn_forward.cu", "                             (smem * 100 + 233471) / 233472);",
        "                             100);")]),
    "k1 corner loads all from 64 pixel rows (L1 hits)": (K1_SRC, [(
        "dcn_forward.cu", "p.x + static_cast<size_t>(o4[cn]) * p.Cin + ch",
        "p.x + static_cast<size_t>(o4[cn] & 63) * p.Cin + ch")]),
    "k1 no corner loads": (K1_SRC, [(
        "dcn_forward.cu", "raw[i][cn] = live && o4[cn] >= 0",
        "raw[i][cn] = false && o4[cn] >= 0")]),
    "k1 no gather (A left unwritten)": (K1_SRC, [(
        "dcn_forward.cu", "          uint4 raw[8][4];", "#if 0\n          uint4 raw[8][4];"), (
        "dcn_forward.cu",
        "            *reinterpret_cast<uint4*>(st + px * 128 + ((q ^ (px & 7)) << 4)) = o;\n"
        "          }\n",
        "            *reinterpret_cast<uint4*>(st + px * 128 + ((q ^ (px & 7)) << 4)) = o;\n"
        "          }\n#endif\n")]),
    "k1 on half the SMs (same tiles)": (K1_SRC, [(
        "dcn_forward.cu", "  const int grid = p.tiles < sms ? p.tiles : sms;",
        "  const int grid = p.tiles < sms / 2 ? p.tiles : sms / 2;")]),
    "k1 no MMA": (K1_SRC, [(
        "dcn_forward.cu", "        hop::mma_slice<BN, 0, 0>(acc, da, db);\n", "")]),
    "k5 base": (K5_SRC, []),
    "k5 B box of BN rows (zero-filled past Ch)": (K5_SRC, [(
        "osa_wgmma.cuh", "  p->b_rows = Cout < bn ? Cout : bn;", "  p->b_rows = bn;")]),
    "k5 no MMA": (K5_SRC, [(
        "osa_wgmma.cuh", "  hop::mma_slice<BN, 0, 0>(d, da, db);\n", "")]),
    "k5 no A loads": (K5_SRC, [(
        "osa_wgmma.cuh",
        "              hop::mbar_expect_tx(&full[r.stage], (BM + p.b_rows) * BK * 2);\n"
        "              if constexpr (kConv) {\n"
        "                const int i0 = (mt / p.tiles_w) * (BM / p.bw);\n"
        "                const int j0 = (mt % p.tiles_w) * p.bw;\n"
        "                hop::tma_load_4d(sa + r.stage * BM * BK, &p.a[0], &full[r.stage], k0,\n"
        "                                 j0 - 1 + tap % 3, i0 - 1 + tap / 3, img);\n",
        "              hop::mbar_expect_tx(&full[r.stage], (kConv ? p.b_rows : BM + p.b_rows) * BK * 2);\n"
        "              if constexpr (kConv) {\n")]),
    "k5 no B loads": (K5_SRC, [(
        "osa_wgmma.cuh",
        "              hop::mbar_expect_tx(&full[r.stage], (BM + p.b_rows) * BK * 2);\n",
        "              hop::mbar_expect_tx(&full[r.stage], (kConv ? BM : BM + p.b_rows) * BK * 2);\n"), (
        "osa_wgmma.cuh",
        "                hop::tma_load_3d(sb + r.stage * BN * BK, &p.b[0], &full[r.stage], k0,\n"
        "                                 tap, nt * BN);\n", "")]),
    "k6 base": (K6_SRC, []),
    "k6 BN = 128 tiles for Cm = 64 (conv1, conv2)": (K6_SRC, [(
        "bottleneck.cu", "  return cm <= 64 ? 64 : cm <= 128 ? 128 :",
        "  return cm <= 128 ? 128 :")]),
    # the other downsample design: its product written by a launch of its
    # own and read back as the residual.  Written here in bfloat16 into the
    # output (each tile's residual is read before its store), so it moves
    # half the bytes of the float32 design: a lower bound on its time
    "k6 downsample as its own launch, read back as the residual (bf16)": (K6_SRC, [(
        "bottleneck.cu", "  if (ds) {\n    p.scale2 = sd;\n",
        "  if (ds) {\n"
        "    osa::OsaParams q{};\n"
        "    const int rq = osa::reduce_params(&q, 1, &x, &wd, &cin, &cin, N, H, W, cout,\n"
        "                                      kConv3BN);\n"
        "    if (rq != 0) return rq;\n"
        "    q.scale = sd;\n    q.bias = bd;\n    q.out = static_cast<hop::bf16*>(out);\n"
        "    const int rl = launch<kConv3BN>(bottleneck_reduce_wgmma_kernel<kConv3BN, 0>, q,\n"
        "                                    out, false, N, stream);\n"
        "    if (rl != 0) return rl;\n"
        "    p.n_pieces = 1;\n"
        "    if (!osa::slot_map(&p.r, out, p, false, N))\n"
        "      return static_cast<int>(cudaErrorInvalidValue);\n"
        "    return launch<kConv3BN>(bottleneck_reduce_wgmma_kernel<kConv3BN, 1>, p, out,\n"
        "                            false, N, stream);\n"
        "  }\n  if (ds) {\n    p.scale2 = sd;\n")]),
    "k6 no MMA": (K6_SRC, [(
        "osa_wgmma.cuh", "  hop::mma_slice<BN, 0, 0>(d, da, db);\n", "")]),
    "k6 no output stores": (K6_SRC, [(
        "osa_wgmma.cuh",
        "    if constexpr (kConv)\n"
        "      hop::tma_store_4d(&p.o, src, nt * BN + h * 64, (mt % p.tiles_w) * p.bw,\n"
        "                        (mt / p.tiles_w) * (BM / p.bw), img);\n"
        "    else\n"
        "      hop::tma_store_3d(&p.o, src, nt * BN + h * 64, mt * BM, img);\n",
        "    (void)src;\n")]),
    "k6 no residual loads": (K6_SRC, [(
        "osa_wgmma.cuh",
        "          if constexpr (kResid == 1) {\n            const int boxes",
        "          if constexpr (kResid == -1) {\n            const int boxes")]),
    "k8 base": (K8_SRC, []),
    "k8 G = 2 lanes a sample (16 channels a lane)": (K8_SRC, [(
        "msdeform_backward.cu", "msdeform_backward_taps_group_kernel<4, 2>",
        "msdeform_backward_taps_group_kernel<2, 4>")]),
    "k8 G = 8 lanes a sample (4 channels a lane)": (K8_SRC, [(
        "msdeform_backward.cu", "msdeform_backward_taps_group_kernel<4, 2>",
        "msdeform_backward_taps_group_kernel<8, 1>")]),
    "k8 one query a warp": (K8_SRC, [(
        "msdeform_backward.cu", "constexpr int kGroupQueries = 4;",
        "constexpr int kGroupQueries = 1;")]),
    "k8 query-major order": (K8_SRC, [(
        "msdeform_backward.cu", "inv_qp = 1.f / (nq * P);", "inv_lp = 1.f / LP;"), (
        "msdeform_backward.cu",
        "      const int lu = small_div(u, inv_qp), rem = u - lu * nq * P;\n"
        "      int i = small_div(rem, inv_p), s = lu * P + rem - i * P;\n",
        "      int i = small_div(u, inv_lp), s = u - i * LP;\n")]),
    "k8 no value loads": (K8_SRC, [_NO_VALUE_LOADS]),
    "k8 no group sums": (K8_SRC, [(
        "msdeform_backward.cu",
        "        sg += __shfl_xor_sync(0xffffffffu, sg, o);\n"
        "        sx += __shfl_xor_sync(0xffffffffu, sx, o);\n"
        "        sy += __shfl_xor_sync(0xffffffffu, sy, o);\n", "")]),
    "k7 base": (K7_SRC, []),
    "k7 G = 2 lanes a query (16 channels a lane)": (K7_SRC, [(
        "msdeform_forward.cu", "launch_forward_group<4, 2>", "launch_forward_group<2, 4>")]),
    "k7 G = 8 lanes a query (4 channels a lane)": (K7_SRC, [(
        "msdeform_forward.cu", "launch_forward_group<4, 2>", "launch_forward_group<8, 1>")]),
    "k7 two samples a group in flight (16 a warp)": (K7_SRC, [(
        "msdeform_forward.cu", "  constexpr int R = 8 / NG > 0 ? 8 / NG : 1;",
        "  constexpr int R = 16 / NG > 0 ? 16 / NG : 1;")]),
    "k7 8 warps a block": (K7_SRC, [(
        "msdeform_forward.cu", "constexpr int kGroupWarps = 4;",
        "constexpr int kGroupWarps = 8;")]),
    "k7 next sample's location and weight loaded ahead": (K7_SRC, [(
        "msdeform_forward.cu",
        "  for (int s0 = 0; s0 < LP; s0 += R) {\n",
        "  float2 uv_next = live_q ? __ldg(loc_i) : make_float2(0.f, 0.f);\n"
        "  float a_next = live_q ? __ldg(att_i) : 0.f;\n"
        "  for (int s0 = 0; s0 < LP; s0 += R) {\n"), (
        "msdeform_forward.cu",
        "      const float2 uv = live ? __ldg(loc_i + s) : make_float2(0.f, 0.f);\n"
        "      a[r] = live ? __ldg(att_i + s) : 0.f;\n",
        "      const float2 uv = uv_next;\n      a[r] = a_next;\n"
        "      if (live && s + 1 < LP) {\n        uv_next = __ldg(loc_i + s + 1);\n"
        "        a_next = __ldg(att_i + s + 1);\n      }\n")]),
    "k7 no value loads": (K7_SRC, [_NO_VALUE_LOADS]),
    "k9 base": (K9_SRC, []),
    "k9 PTX red.global.add.v4.f32 in place of atomicAdd(float4 *)": (K9_SRC, [(
        "msdeform_gather.cuh", _RED_ADD4,
        '  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\\n" ::"l"(p),'
        ' "f"(v.x), "f"(v.y),\n               "f"(v.z), "f"(v.w) : "memory");\n')]),
    "k9 G = 4 lanes a query (8 channels a lane, K7's layout)": (K9_SRC, [(
        "msdeform_backward.cu", "launch_value_group<8, 1>", "launch_value_group<4, 2>")]),
    "k9 G = 2 lanes a query (16 channels a lane)": (K9_SRC, [(
        "msdeform_backward.cu", "launch_value_group<8, 1>", "launch_value_group<2, 4>")]),
    "k9 scalar atomics in the group layout": (K9_SRC, [(
        "msdeform_gather.cuh", _RED_ADD4,
        "  atomicAdd(p, v.x);\n  atomicAdd(p + 1, v.y);\n  atomicAdd(p + 2, v.z);\n"
        "  atomicAdd(p + 3, v.w);\n")]),
    # the reduction replaced by a store that no value of these inputs makes
    "k9 no atomics (compute only)": (K9_SRC, [(
        "msdeform_gather.cuh", _RED_ADD4,
        "  if (v.x == 1.17549435e-38f && v.y == v.z) *p = v.w;\n")]),
    "k9 a sample's four corners into its first corner row on the map (contention)": (
        K9_SRC, [(
            "msdeform_backward.cu",
            "        if (c.v00) msd::red_add4(c00 + ch, scaled(ga, w00));\n"
            "        if (c.v01) msd::red_add4(c00 + row + ch, scaled(ga, w01));\n"
            "        if (c.v10) msd::red_add4(c10 + ch, scaled(ga, w10));\n"
            "        if (c.v11) msd::red_add4(c10 + row + ch, scaled(ga, w11));\n",
            "        float* c0 = (c.v00 ? c00 : c.v01 ? c00 + row : c.v10 ? c10 : c10 + row) + ch;\n"
            "        if (c.v00) msd::red_add4(c0, scaled(ga, w00));\n"
            "        if (c.v01) msd::red_add4(c0, scaled(ga, w01));\n"
            "        if (c.v10) msd::red_add4(c0, scaled(ga, w10));\n"
            "        if (c.v11) msd::red_add4(c0, scaled(ga, w11));\n")]),
}


VARIANT_KINDS = ("k1", "k2", "k5", "k6", "k7", "k8", "k9")


def variant_library(name: str):
    """The library of one knock-out variant: its sources copied from
    ``csrc/`` under ``build/variants/``, patched and built."""
    import shutil

    from transcar_tpu_torch.ops import kernel_lib

    sources, patches = VARIANTS[name]
    tag = "variants/" + "".join(c if c.isalnum() else "_" for c in name)
    src = kernel_lib.BUILD_DIR / tag / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in sources:
        shutil.copy(kernel_lib.CSRC / f, src / f)
    for target, old, new in patches:
        text = (src / target).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: patch target not in {target}: "
                               f"{old!r}")
        (src / target).write_text(text.replace(old, new))
    return csrc_library(src, tag)


def _variant_calls(kind: str) -> list:
    """(label, launches per request or step, call(lib)[, check(lib)]) of
    the K2 entry at a batch-1 fusion layer (check: its error against the
    plain version), of the K1 entry at
    the flagship DCN shapes (offsets ±8 px and the model's), of K5's chain
    tile at the 7 VoVNet-99 block shapes (5 convs each), of K6's three
    Hopper-tile entries at the 3 R101 bottleneck shapes, or of K7's, K8's
    or K9's lane-group entry at one encoder and one decoder call of the
    pillar shapes."""
    from transcar_tpu_torch.ops import (pallas_bottleneck, pallas_dcn,
                                        pallas_osa_block)

    vp = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls = []
    if kind == "k2":
        from transcar_tpu_torch.ops.attention import attention_core

        g = torch.Generator(device="cuda").manual_seed(22)
        case = k2_case(g, 1)
        ref = attention_core(*case[:3], ~case[3])
        gate = case[3].any(-1)
        entries = {}                   # a library's (call, out)

        def call(lib):
            if lib not in entries:
                entries[lib] = k2_entry(lib, *case)
            return entries[lib][0]()

        def check(lib):
            call(lib)
            diff = (entries[lib][1] - ref).abs().transpose(1, 2)
            torch.cuda.synchronize()
            return (f" max_abs_err {diff[gate].max().item():.3e} gated, "
                    f"{diff[~gate].max().item():.3e} fully masked")
        return [(f"[1x{K2_SHAPE[0]}, {K2_SHAPE[1]}x{K2_SHAPE[2]}]",
                 K2_PER_REQ, call, check)]
    if kind == "k1":
        g = torch.Generator(device="cuda").manual_seed(11)
        for n, h, w, cin, cout, per_req in FLAGSHIP_DCN:
            for offsets in ("pm8", "model"):
                x, om, wt, _ = dcn_backward_case(g, n, h, w, cin, cout,
                                                 torch.bfloat16, offsets)
                t = (x, om, pallas_dcn.kmajor_weight(wt), torch.empty(
                    (n, h, w, cout), dtype=torch.bfloat16, device="cuda"))
                calls.append((f"[{n},{h},{w},{cin}]->{cout} {offsets}", per_req,
                              lambda lib, t=t, d=(n, h, w, cin, cout):
                              lib.dcn_forward_bf16_wgmma(*map(vp, t), *d,
                                                         stream())))
        return calls
    if kind == "k6":
        g = torch.Generator(device="cuda").manual_seed(16)
        for (x, ws, affs, kw), (h, w, cin, cm, cout, ds, per_req) in zip(
                (k6_case(g, torch.bfloat16, *shape[:6]) for shape in R101_K6),
                R101_K6):
            ks = pallas_bottleneck.kmajor_weights(*ws, kw.get("wd"))
            h1 = torch.empty((6, h, w, cm), dtype=x.dtype, device="cuda")
            h2, out = torch.empty_like(h1), torch.empty(
                (6, h, w, cout), dtype=x.dtype, device="cuda")
            (s1, b1), (s2, b2), (s3, b3) = affs
            sd, bd = kw.get("affd", (None, None))
            label = f"6x{h}x{w} {cin}->{cm}->{cout}"
            a, d = (s1, b1, s2, b2, s3, b3, sd, bd), (6, h, w)
            calls += [
                (f"{label} conv1", per_req,
                 lambda lib, x=x, k=ks[0], a=a, h1=h1, d=d, cin=cin, cm=cm:
                 lib.bottleneck_conv1_bf16_wgmma(
                     vp(x), cin, vp(k), vp(a[0]), vp(a[1]), vp(h1), *d, cm,
                     stream())),
                (f"{label} conv2", per_req,
                 lambda lib, k=ks[1], a=a, h1=h1, h2=h2, d=d, cm=cm:
                 lib.bottleneck_conv2_bf16_wgmma(
                     vp(h1), cm, vp(k), vp(a[2]), vp(a[3]), vp(h2), *d,
                     stream())),
                (f"{label} conv3", per_req,
                 lambda lib, x=x, k=ks, a=a, h2=h2, o=out, d=d, cin=cin,
                 cm=cm, cout=cout: lib.bottleneck_conv3_bf16_wgmma(
                     vp(h2), cm, vp(k[2]), vp(a[4]), vp(a[5]), vp(x), cin,
                     vp(k[3]), vp(a[6]), vp(a[7]), vp(o), *d, cout,
                     stream()))]
        return calls
    if kind in ("k7", "k8", "k9"):
        g = torch.Generator(device="cuda").manual_seed(18)
        s = sum(h * w for h, w in BEV_LEVELS)
        levels = [(ctypes.c_int * 4)(*v) for v in (
            [h for h, _ in BEV_LEVELS], [w for _, w in BEV_LEVELS],
            [sum(h * w for h, w in BEV_LEVELS[:i]) for i in range(4)])]
        for name, q, per_call in (("encoder", s, 2), ("decoder", 300, 6)):
            value, loc, wgt = msdeform_case(g, q, name == "encoder")
            d_out = torch.randn(1, q, 256, device="cuda", generator=g)
            shape = (1, s, q, 8, 32, 4, 4, *levels)
            if kind == "k7":
                t = (value, loc, wgt, torch.empty_like(d_out))
                call = (lambda lib, t=t, d=shape:
                        lib.msdeform_forward_group_f32(*map(vp, t), *d, stream()))
            elif kind == "k8":
                t = (value, loc, wgt, d_out, torch.empty_like(loc),
                     torch.empty_like(wgt))
                call = (lambda lib, t=t, d=shape:
                        lib.msdeform_backward_taps_group_f32(*map(vp, t), *d,
                                                             stream()))
            else:       # with the zero-fill of d_value that its wrapper makes
                t = (loc, wgt, d_out, torch.zeros_like(value))
                call = (lambda lib, t=t, d=shape: (
                    t[3].zero_(), lib.msdeform_backward_value_group_f32(
                        *map(vp, t), *d, stream()))[1])
            calls.append((f"{name} Q={q}", per_call, call))
        return calls
    g = torch.Generator(device="cuda").manual_seed(12)
    for h, w, c0, ch, _, per_req in VOV_BLOCKS:
        for i, cin in enumerate([c0] + [ch] * 4):
            x = torch.randn(6, h, w, cin, device="cuda", generator=g).bfloat16()
            w9 = torch.randn(3, 3, cin, ch, device="cuda",
                             generator=g) / math.sqrt(9 * cin)
            s, b = _affine(g, ch)
            wk = pallas_osa_block.kmajor_conv_weight(w9, torch.bfloat16)
            o = torch.empty((6, h, w, ch), dtype=torch.bfloat16, device="cuda")
            calls.append((f"6x{h}x{w} {cin}->{ch} conv{i}", per_req,
                          lambda lib, x=x, cin=cin, t=(wk, s, b, o),
                          d=(6, h, w, ch): lib.osa_conv3x3_bf16_wgmma(
                              vp(x), cin, *map(vp, t), *d, stream())))
    return calls


def phase_variants(kinds, smi: str) -> None:
    """Each knock-out variant of ``kinds`` ("k1", "k2", "k5", "k6", "k7",
    "k8", "k9"): ms per request or step (CUDA events; K2's launches queued
    behind a spin kernel) at the main path's shapes, by offsets for K1 and
    by call for K7-K9, timed in turns with the unpatched kernel
    ("<kind> base"; base, variant, variant, base at every call, each the
    better of its two turns) so that every reading has a paired one; K2's
    variants also print their error against the plain version."""
    for kind in kinds:
        calls = _variant_calls(kind)
        base = variant_library(f"{kind} base")
        for name in VARIANTS:
            if not name.startswith(kind):
                continue
            lib = base if name == f"{kind} base" else variant_library(name)
            per_req, base_req, parts = {}, {}, []
            for label, n, call, *check in calls:
                if call(lib) != 0:
                    raise RuntimeError(f"{name} failed at {label}")
                iters = 20 if kind == "k1" else 10
                timer = (queued_ms if kind == "k2"
                         else lambda f: cuda_ms(f, iters=iters))
                var = lambda: call(lib)
                turns = [timer(f) for f in (lambda: call(base), var, var,
                                            lambda: call(base))]
                ms, base_ms = min(turns[1:3]), min(turns[0], turns[3])
                key = (label.rsplit(" ", 1)[-1] if kind in ("k1", "k6")
                       else label.split(" ", 1)[0]
                       if kind in ("k7", "k8", "k9") else "all")
                per_req[key] = per_req.get(key, 0.0) + n * ms
                base_req[key] = base_req.get(key, 0.0) + n * base_ms
                parts.append(f"{label} {ms:.4f} (base {base_ms:.4f})"
                             + (check[0](lib) if check else ""))
            unit = "step" if kind in ("k8", "k9") else "request"
            print(f"{name}: per {unit} "
                  + ", ".join(f"{k} {v:.3f} ms (base {base_req[k]:.3f})"
                              for k, v in per_req.items())
                  + " | " + ", ".join(parts) + f" ({smi})", flush=True)
        del calls
        torch.cuda.empty_cache()


def parent_dcn_forward(lib, x, om, wt):
    """The parent commit's bfloat16 K1 with its wrapper's preparation: its
    Hopper tile ``lib.dcn_forward_bf16_wgmma`` on the K-major weight where
    the library has one, else its wmma tile ``lib.dcn_forward_bf16`` on
    the [9·Cin, Cout] weight."""
    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    wgmma = hasattr(lib, "dcn_forward_bf16_wgmma")
    w9 = (wt.permute(3, 0, 1, 2) if wgmma else wt).to(x.dtype).contiguous()
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device="cuda")
    rc = (lib.dcn_forward_bf16_wgmma if wgmma else lib.dcn_forward_bf16)(
        *(ctypes.c_void_p(t.data_ptr()) for t in (x, om, w9, out)),
        n, h, w, cin, cout,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"parent K1: CUDA error {rc}")
    return out


def in_turns(kern, old, timer=cuda_ms) -> tuple:
    """(kernel ms, parent ms, the line's text): timed parent, kernel,
    kernel, parent; each the better of its two turns."""
    turns = [timer(f) for f in (old, kern, kern, old)]
    return (min(turns[1:3]), min(turns[0], turns[3]),
            f"parent {turns[0]:.4f} / {turns[3]:.4f} ms, kernel "
            f"{turns[1]:.4f} / {turns[2]:.4f} ms")


def phase_k1(parent=None) -> dict:
    """K1 against its plain version at both flagship shapes: bfloat16 on
    the Hopper tile and float32 on the first tile, offsets over ±8 px,
    zero, whole-pixel and (bfloat16) at the model's scale; per R101
    request (23 + 3 launches) beside cuDNN's 3×3 convolution of the same
    shapes (the GEMM without the gather, a reference line) and beside the
    parent commit's K1 (``parent``: its kernel library) when given."""
    from transcar_tpu_torch.ops import kernel_lib, pallas_dcn
    from transcar_tpu_torch.ops.dcn import modulated_deform_conv

    g = torch.Generator(device="cuda").manual_seed(1)
    result = _kernel_result()
    result["parent_ms"] = 0.0 if parent is not None else None
    per_req = {"model": 0.0, "parent_model": 0.0, "cudnn": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for n, h, w, cin, cout, launches in FLAGSHIP_DCN:
            cases = ("pm8", "zero", "integer") + (
                ("model",) if dtype == torch.bfloat16 else ())
            for offsets in cases:
                x, om, wt, _ = dcn_backward_case(g, n, h, w, cin, cout, dtype,
                                                 offsets)
                wt = wt.to(dtype)
                # the K-major copy the model caches (models/resnet.DCNConv)
                wk = pallas_dcn.kmajor_weight(wt, dtype)
                before = pallas_dcn.wgmma_launches
                out = pallas_dcn.fused_deform_conv(x, om, wt, wk)
                took = pallas_dcn.wgmma_launches - before
                ref = modulated_deform_conv(x, om, wt)
                torch.cuda.synchronize()
                err, rel = _rel_err(out, ref)
                want_tile = int(dtype == torch.bfloat16)
                ok = (math.isfinite(rel) and rel <= DCN_TOL[dtype]
                      and took == want_tile)
                line = (f"K1 dcn {str(dtype)[6:]} x[{n},{h},{w},{cin}]->{cout}"
                        f" offsets {offsets} "
                        f"({'wgmma tile' if took else 'wmma tile'}): "
                        f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol "
                        f"{DCN_TOL[dtype]:.0e} of max|plain|)")
                del ref
                if dtype == torch.bfloat16 and offsets in ("pm8", "model"):
                    kern = lambda: pallas_dcn.fused_deform_conv(x, om, wt, wk)
                    if parent is not None:
                        ms, old_ms, text = in_turns(
                            kern, lambda: parent_dcn_forward(parent, x, om, wt))
                        line += "; " + text
                    else:
                        ms, old_ms = cuda_ms(kern), 0.0
                        line += f"; kernel {ms:.3f} ms"
                    if offsets == "model":
                        per_req["model"] += launches * ms
                        per_req["parent_model"] += launches * old_ms
                    else:
                        plain_ms = cuda_ms(lambda: modulated_deform_conv(
                            x, om, wt), iters=5, warmup=1)
                        # the reference line: cuDNN's bf16 3x3 conv of the
                        # same shapes, the GEMM a DCN does without its gather
                        xc = x.permute(0, 3, 1, 2)
                        wc = wt.permute(3, 2, 0, 1).contiguous(
                            memory_format=torch.channels_last)
                        cudnn_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
                            xc, wc, padding=1))
                        del xc, wc
                        bound = dcn_bound_ms(x, om, wt, out)
                        result["max_abs_err"] = max(result["max_abs_err"], err)
                        result["ms"] += launches * ms
                        result["plain_ms"] += launches * plain_ms
                        result["bound_ms"] += launches * bound
                        per_req["cudnn"] += launches * cudnn_ms
                        if parent is not None:
                            result["parent_ms"] += launches * old_ms
                        line += (f", plain {plain_ms:.3f} ms, cuDNN 3x3 conv "
                                 f"(no gather) {cudnn_ms:.3f} ms, bound "
                                 f"{bound:.3f} ms (kernel at {bound / ms:.0%}"
                                 f" of it)")
                print(line + (" ok" if ok else " FAIL"))
                if not ok:
                    raise AssertionError(f"K1 {dtype} {offsets} disagrees with "
                                         f"its plain version ({rel}) or took "
                                         f"the wrong tile ({took})")
                del x, om, wt, wk, out
    print(f"K1 per request on the bfloat16 path (23 + 3 launches, wgmma "
          f"tile), offsets pm8: kernel {result['ms']:.3f} ms, plain "
          f"{result['plain_ms']:.3f} ms, bound {result['bound_ms']:.3f} ms"
          + (f", parent K1 {result['parent_ms']:.3f} ms (kernel / parent "
             f"{result['ms'] / result['parent_ms']:.3f})" if parent else "")
          + f"; offsets at the model's scale: kernel {per_req['model']:.3f} ms"
          + (f", parent {per_req['parent_model']:.3f} ms (kernel / parent "
             f"{per_req['model'] / per_req['parent_model']:.3f})"
             if parent else "")
          + f"; reference: cuDNN bf16 3x3 conv of the same shapes "
          f"{per_req['cudnn']:.3f} ms (no single PyTorch call computes "
          f"DCNv2)")
    log = kernel_lib.library_path().with_suffix(".log").read_text()
    print("K1 tile ptxas -v: " + " | ".join(
        ln for ln in ptxas_lines(log) if ln.startswith("dcn_forward_wgmma")))
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
    """The parent commit's K3 with its wrapper's preparation: its two
    entries ``dcn_backward_data_bf16`` and ``dcn_backward_weight_bf16``, or
    the one ``dcn_backward_bf16`` of a commit before they were split."""
    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    w_t = wt.to(x.dtype).contiguous()
    d_x = torch.zeros((n, h, w, cin), dtype=torch.float32, device="cuda")
    d_om = torch.empty_like(om)
    d_w = torch.zeros((9 * cin, cout), dtype=torch.float32, device="cuda")
    vp = lambda *ts: [ctypes.c_void_p(t.data_ptr()) for t in ts]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if hasattr(lib, "dcn_backward_data_bf16"):
        rcs = [lib.dcn_backward_data_bf16(*vp(x, om, w_t, d_out, d_x, d_om),
                                          n, h, w, cin, cout, stream),
               lib.dcn_backward_weight_bf16(*vp(x, om, d_out, d_w),
                                            n, h, w, cin, cout, stream)]
    else:
        rcs = [lib.dcn_backward_bf16(*vp(x, om, w_t, d_out, d_x, d_om, d_w),
                                     n, h, w, cin, cout, stream)]
    if any(rcs):
        raise RuntimeError(f"parent K3: CUDA errors {rcs}")
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
                        ms, old_ms, text = in_turns(kern, old)
                        line += "; " + text
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
    result["parent_ms"] = per_step["parent"] if parent is not None else None
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


K2_SHAPE = (8, 900, 1500)      # heads, queries, radar tokens of a fusion layer
K2_PER_REQ = 3                  # fusion layers a request


def k2_case(g, b: int):
    """Seeded K2 inputs in the main path's layout: q, k and v the
    ``split_heads`` views of [B, L, 256] projections; keep of density 0.2
    with a fully visible row and two fully masked ones."""
    from transcar_tpu_torch.ops.attention import split_heads

    heads, nq, t = K2_SHAPE
    qh, kh, vh = (split_heads(torch.randn(b, n, heads * 32, device="cuda",
                                          generator=g), heads)
                  for n in (nq, t, t))
    keep = torch.rand(b, nq, t, device="cuda", generator=g) < 0.2
    keep[:, 0] = True
    keep[:, 1] = False
    keep[:, nq - 1] = False
    return qh, kh, vh, keep


def k2_entry(lib, qh, kh, vh, keep):
    """(call, out): ``lib``'s K2 C entry on these inputs with its arguments
    made once, so that a call is one ctypes call returning the CUDA error.
    The tensor-core entry ``masked_attention_wgmma_f32`` reads the views
    in place; an earlier commit's ``masked_attention_f32`` takes contiguous
    [B·H, L, 32] copies, made here, outside the timed calls."""
    from transcar_tpu_torch.ops import pallas_attention as pa

    b, h, nq, hd = qh.shape
    t = kh.shape[2]
    vp = lambda x: ctypes.c_void_p(x.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    scale = ctypes.c_float(1.0 / math.sqrt(hd))
    if hasattr(lib, "masked_attention_wgmma_f32"):
        fn = lib.masked_attention_wgmma_f32
        fn.argtypes, fn.restype = list(pa.ENTRY_ARGTYPES), ctypes.c_int
        out = torch.empty((b, nq, h, hd), device="cuda").transpose(1, 2)
        rows = pa.keep_rows(keep)
        held = (qh, kh, vh, rows, out)
        args = (*map(vp, held), (ctypes.c_longlong * 14)(
            *pa.kernel_strides(qh, kh, vh, out), *rows.stride()[:2]),
            b, h, nq, t, rows.shape[-1], hd, scale, stream)
    else:
        fn = lib.masked_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.empty((b, h, nq, hd), device="cuda")
        held = (qh.contiguous(), kh.contiguous(), vh.contiguous(),
                keep.contiguous().view(torch.uint8), out)
        args = (*map(vp, held), b * h, h, nq, t, hd, scale, stream)
    return (lambda held=held: fn(*args)), out


def queued_ms(fn, iters: int = 50) -> float:
    """Device ms of ``fn()`` launched ``iters`` times back to back (CUDA
    events): the launches queue up behind a ~10 ms spin kernel, so the
    host's time per launch (a wrapper's checks, ctypes) stays out of a
    reading of a ~35 µs kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host µs per call of ``fn()`` (``time.perf_counter``): what the
    calls cost the host, whatever the device does meanwhile (a launch
    returns at once until ~1000 are queued)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e6 * took / iters


def k2_bounds(qh, kh, vh, keep, out) -> tuple:
    """(bound ms, "operations" or "bytes", float32 FMA bound ms) of one K2
    launch: the two products as three TF32 products at 495 TFLOP/s, or as
    float32 FMAs at 67, over q, k, v and keep read once and out written
    once."""
    b, h, nq, hd = qh.shape
    flops = 4.0 * b * h * nq * kh.shape[2] * hd
    moved = nbytes(qh, kh, vh, keep, out)
    t_ops, t_mem = 3 * flops / TF32_FLOPS, moved / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem
            else "bytes", bound_ms(flops, torch.float32, moved)[0])


def phase_k2(parent=None) -> dict:
    """K2 against its plain version at the fusion layers' shape (8 heads ×
    900 queries × 1500 tokens, hd 32) at batch 1 and 4, on the main path's
    strided views, every row (fully masked ones too); per request (3
    launches) through the bare entry and the wrapper, beside
    ``F.scaled_dot_product_attention``, both bounds and, when given, the
    parent commit's K2 (``parent``: its kernel library) in turns; at
    batch 1 also the host µs a call of the wrapper, the bare entry and
    the wrapper's parts, and both timed back to back with no queue."""
    from transcar_tpu_torch.ops import kernel_lib, pallas_attention
    from transcar_tpu_torch.ops.attention import attention_core

    g = torch.Generator(device="cuda").manual_seed(2)
    result = _kernel_result()
    heads, nq, t = K2_SHAPE
    n = K2_PER_REQ
    for b in (1, 4):
        qh, kh, vh, keep = k2_case(g, b)
        before = pallas_attention.mma_launches
        out = pallas_attention.masked_attention(qh, kh, vh, keep)
        took = pallas_attention.mma_launches - before
        ref = attention_core(qh, kh, vh, ~keep)
        torch.cuda.synchronize()
        gate = keep.any(-1)
        diff = (out - ref).abs().transpose(1, 2)          # [B, Q, H, hd]
        err, masked_err = diff[gate].max().item(), diff[~gate].max().item()
        finite = bool(torch.isfinite(out).all())
        call, _ = k2_entry(kernel_lib.library(), qh, kh, vh, keep)
        line = (f"K2 attention [{b}x{heads}, {nq}x{t}, hd 32] on split_heads "
                f"views, keep density {keep.float().mean().item():.3f}: "
                f"max_abs_err {err:.3e} on {int(gate.sum())} gated rows, "
                f"{masked_err:.3e} on {int((~gate).sum())} fully masked "
                f"(tol {ATTN_TOL:.0e}), all finite {finite}, {took} mma "
                f"launch")
        if parent is not None:
            old, old_out = k2_entry(parent, qh, kh, vh, keep)
            if old() != 0:
                raise RuntimeError("parent K2 failed")
            torch.cuda.synchronize()
            old_err = (old_out.view(b, heads, nq, 32) - ref).abs().transpose(
                1, 2)[gate].max().item()
            ms, old_ms, text = in_turns(call, old, queued_ms)
            line += (f"; parent max_abs_err {old_err:.3e} on the gated rows "
                     f"(kernel / parent {err / old_err:.2f}); {text} a launch")
        else:
            ms, old_ms = queued_ms(call), None
            line += f"; kernel {ms:.4f} ms a launch"
        wrap = lambda: pallas_attention.masked_attention(qh, kh, vh, keep)
        wrap_ms = queued_ms(wrap)
        if b == 1:
            # what a launch costs the host, and the calls back to back with
            # no queue ahead of them (as the model issues them when the
            # host is behind): the device then waits for the slower side
            lib = kernel_lib.library()
            rows = pallas_attention.keep_rows(keep)
            entry = lib["masked_attention_wgmma_f32"]
            host = {"wrapper": host_us(wrap), "entry": host_us(call),
                    "typing the entry": host_us(lambda: setattr(
                        entry, "argtypes",
                        list(pallas_attention.ENTRY_ARGTYPES))),
                    "stride array": host_us(
                        lambda: (ctypes.c_longlong * 14)(
                            *pallas_attention.kernel_strides(qh, kh, vh, out),
                            *rows.stride()[:2])),
                    "empty ctypes call": host_us(
                        lambda: lib.tck_error_string(0))}
            if parent is not None:
                host["parent entry"] = host_us(old)
            print(f"K2 host µs a call [1x{heads}, {nq}x{t}]: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
                  + f"; back to back, no queue ahead: wrapper "
                  f"{cuda_ms(wrap, iters=50):.4f} ms, entry "
                  f"{cuda_ms(call, iters=50):.4f} ms a launch", flush=True)
        plain_ms = cuda_ms(lambda: attention_core(qh, kh, vh, ~keep),
                           iters=5, warmup=1)
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=keep[:, None]))
        bound, bound_by, fp32_bound = k2_bounds(qh, kh, vh, keep, out)
        line += (f"; per request of {b} ({n} launches): kernel {n * ms:.4f}"
                 + (f" ms, parent {n * old_ms:.4f} ms (kernel / parent "
                    f"{ms / old_ms:.3f})" if parent is not None else " ms")
                 + f", through the wrapper {n * wrap_ms:.4f} ms, plain "
                 f"{n * plain_ms:.4f} ms, scaled_dot_product_attention "
                 f"{n * library_ms:.4f} ms, bound {n * bound:.4f} ms by "
                 f"{bound_by} (three TF32 products; float32 FMA bound "
                 f"{n * fp32_bound:.4f} ms, kernel at {fp32_bound / ms:.0%} "
                 f"of it)")
        ok = (finite and max(err, masked_err) <= ATTN_TOL and took == 1)
        print(line + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            raise AssertionError(f"K2 at batch {b} disagrees with its plain "
                                 f"version or missed the mma kernel")
        if b == 1:
            result.update(max_abs_err=max(err, masked_err), ms=n * ms,
                          plain_ms=n * plain_ms, bound_ms=n * bound,
                          bound_by=bound_by, library_ms=n * library_ms,
                          parent_ms=None if parent is None else n * old_ms)
        del qh, kh, vh, keep, out, ref, diff
        torch.cuda.empty_cache()
    return result


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
    from transcar_tpu_torch.ops import pallas_attention, pallas_dcn

    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    k1_wgmma = pallas_dcn.wgmma_launches
    k2_mma = pallas_attention.mma_launches
    want = {k: per_req.get(k, 0) * rec["requests"]
            for k in rec["kernel_launches"]}
    valid = _check_outputs("slice", out, cfg)
    print(f"slice {preset} 6x928x1600 bs1 (bf16 backbone, fp32 head): "
          f"{rec['requests']} requests, launches {rec['kernel_launches']} "
          f"(want {per_req} per request, no other kernel), K1 on the wgmma "
          f"tile {k1_wgmma} of {rec['kernel_launches']['dcn_forward']}, K2 "
          f"on the mma kernel {k2_mma} of "
          f"{rec['kernel_launches']['masked_attention']}; outputs finite; "
          f"decode {valid}/300 valid boxes; DCN taps with |dy|>5 px "
          f"{rec['dcn_taps_past_5px']:.4f}; fusion keeps "
          f"{rec['fusion_keep_share']:.3e} of (query, token) pairs")
    if rec["kernel_launches"] != want:
        raise AssertionError(f"kernel launches {rec['kernel_launches']} != "
                             f"{want}")
    if k1_wgmma != want["dcn_forward"]:
        raise AssertionError(f"slice: {want['dcn_forward'] - k1_wgmma} K1 "
                             "launches missed the wgmma tile")
    if k2_mma != want["masked_attention"]:
        raise AssertionError(f"slice: {want['masked_attention'] - k2_mma} "
                             "K2 launches missed the mma kernel")

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
        k1_wgmma = pallas_dcn.wgmma_launches
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
              f"{want[1] // steps} per step), K1 on the wgmma tile {k1_wgmma} "
              f"of {launches[0]}; loss total first "
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
        if k1_wgmma != launches[0]:
            raise AssertionError(f"train {preset}: {launches[0] - k1_wgmma} "
                                 "K1 launches missed the wgmma tile")
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
            "bound_by": "operations", "library_ms": None, "parent_ms": None}


def parent_osa_reduce(lib, pieces, ws, s, b):
    """The K4 of ``lib`` (the parent's, or this build's for a like-for-like
    timing) with its wrapper's preparation: its Hopper tile
    ``lib.osa_reduce_bf16_wgmma`` on the K-major views ``ws`` where the
    library has one, else its wmma tile ``lib.osa_reduce_bf16`` on
    contiguous [Cᵢ, Cout] weights."""
    n, h, w, _ = pieces[0].shape
    cout, k = ws[0].shape[-1], len(pieces)
    wgmma = hasattr(lib, "osa_reduce_bf16_wgmma")
    if not wgmma:
        ws = [wi.contiguous() for wi in ws]
    out = torch.empty((n, h, w, cout), dtype=pieces[0].dtype, device="cuda")
    sums = torch.zeros((n, cout), dtype=torch.float32, device="cuda")
    ptrs = ctypes.c_void_p * k
    ints = ctypes.c_int * k
    rc = (lib.osa_reduce_bf16_wgmma if wgmma else lib.osa_reduce_bf16)(
        k, ptrs(*[p.data_ptr() for p in pieces]),
        ptrs(*[wi.data_ptr() for wi in ws]),
        ints(*[p.shape[-1] for p in pieces]),
        *([ints(*[wi.stride(1) for wi in ws])] if wgmma else []),
        *(ctypes.c_void_p(t.data_ptr()) for t in (s, b, out, sums)),
        n, h, w, cout, 1,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K4 entry: CUDA error {rc}")
    return out, sums


def phase_k4(parent=None) -> dict:
    """K4 at the 7 VoVNet-99 block shapes; per request (16 launches) in
    bfloat16 beside one cuDNN 1×1 convolution over the concatenation, and
    beside the parent commit's K4 (``parent``: its kernel library) when
    given, both timed through their bare entries.  The bfloat16 weights are the K-major views the model caches
    (``pallas_osa.kmajor_weights``)."""
    from transcar_tpu_torch.ops import pallas_osa

    g = torch.Generator(device="cuda").manual_seed(4)
    own = own_library()
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
                # the entry as the parent's is timed: the wrapper's host
                # time would pass a small call's device time
                kern = lambda: parent_osa_reduce(own, pieces, ws, s, b)
                if parent is not None:
                    ms, old_ms, text = in_turns(kern, lambda: parent_osa_reduce(
                        parent, pieces, ws, s, b))
                    parent_ms += per_req * old_ms
                    line += "; " + text
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
    res["parent_ms"] = parent_ms if parent is not None else None
    print(f"K4 per request on the bfloat16 path (16 launches): kernel "
          f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, cuDNN 1x1 "
          f"conv {res['library_ms']:.3f} ms (kernel / cuDNN "
          f"{res['ms'] / res['library_ms']:.3f}), bound {res['bound_ms']:.3f}"
          f" ms ({res['bound_ms'] / res['ms']:.0%} of it)"
          + (f", parent K4 {parent_ms:.3f} ms (kernel / parent "
             f"{res['ms'] / parent_ms:.3f})" if parent is not None else ""))
    return res


def parent_osa_block(lib, x, w9s, affs, rws, raff):
    """The parent commit's bfloat16 K5 with its wrapper's preparation:
    where the library has the chain tile ``lib.osa_conv3x3_bf16_wgmma``,
    its launches on K-major chain weights, then the parent's K4 on the
    chain; else ``lib.osa_block_bf16`` (n_convs + 1 wmma-tile kernels of
    conv_tile.cuh) on tap-major [9·Cin, Ch] chain weights and contiguous
    [Cᵢ, Cr] reduce splits."""
    n, h, w, c0 = x.shape
    k, ch, cr = len(w9s), w9s[0].shape[-1], rws[0].shape[-1]
    vp = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if hasattr(lib, "osa_conv3x3_bf16_wgmma"):
        chain = [x]
        for w9, (sc, bi) in zip(w9s, affs):
            wk = w9.permute(3, 0, 1, 2).to(x.dtype).contiguous()
            chain.append(torch.empty((n, h, w, ch), dtype=x.dtype,
                                     device="cuda"))
            rc = lib.osa_conv3x3_bf16_wgmma(
                vp(chain[-2]), chain[-2].shape[-1], vp(wk), vp(sc), vp(bi),
                vp(chain[-1]), n, h, w, ch, stream)
            if rc != 0:
                raise RuntimeError(f"parent K5 chain tile: CUDA error {rc}")
        return parent_osa_reduce(lib, chain, rws, *raff)
    ws = [w9.to(x.dtype).contiguous() for w9 in w9s]
    rc_ws = [wr.to(x.dtype).contiguous() for wr in rws]
    chain = [torch.empty((n, h, w, ch), dtype=x.dtype, device="cuda")
             for _ in range(k)]
    out = torch.empty((n, h, w, cr), dtype=x.dtype, device="cuda")
    sums = torch.zeros((n, cr), dtype=torch.float32, device="cuda")
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    rc = lib.osa_block_bf16(
        vp(x), c0, k, ch, ptrs(ws), ptrs([a[0] for a in affs]),
        ptrs([a[1] for a in affs]), ptrs(chain), ptrs(rc_ws), vp(raff[0]),
        vp(raff[1]), vp(out), vp(sums), n, h, w, cr, stream)
    if rc != 0:
        raise RuntimeError(f"parent osa_block_bf16: CUDA error {rc}")
    return out, sums


def phase_k5(parent=None) -> dict:
    """K5 at the 7 VoVNet-99 block shapes; per request (16 calls) in
    bfloat16 with its 5 chain-tile launches and its K4 reduce timed apart,
    beside the default path's cost for the same blocks (cuDNN bf16 3×3
    convs, then K4) and beside the parent commit's K5 (``parent``: its
    kernel library) when given.  The weights are the K-major copies and
    views the model caches."""
    from transcar_tpu_torch.ops import pallas_osa, pallas_osa_block

    g = torch.Generator(device="cuda").manual_seed(5)
    res = _kernel_result()
    res["parent_ms"] = 0.0 if parent is not None else None
    per_req = {"chain": 0.0, "reduce": 0.0, "cudnn_chain": 0.0}
    counts = lambda: (pallas_osa_block.launches,
                      pallas_osa_block.wgmma_launches, pallas_osa.launches,
                      pallas_osa.wgmma_launches)
    for dtype in (torch.bfloat16, torch.float32):
        for h, w, c0, ch, cout, per_req_calls in VOV_BLOCKS:
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
            w_all = (torch.randn(cout, sum(widths), device="cuda", generator=g)
                     / math.sqrt(sum(widths)))
            rws = pallas_osa.kmajor_weights(w_all, widths, dtype)
            raff = _affine(g, cout)
            wks = [pallas_osa_block.kmajor_conv_weight(w9, dtype) for w9 in w9s]
            args = (x, w9s, affs, rws, raff)
            before = counts()
            out, sums = pallas_osa_block.osa_block_fused(*args,
                                                         conv_kmajor=wks)
            got = tuple(a - b for a, b in zip(counts(), before))
            ref, ref_sums = pallas_osa_block.plain_osa_block(*args)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            _, srel = _rel_err(sums, ref_sums)
            stol = SUMS_TOL if dtype == torch.float32 else CHAIN_TOL[dtype]
            bf16 = int(dtype == torch.bfloat16)
            want = (1, 5 * bf16, bf16, bf16)
            ok = (math.isfinite(rel) and rel <= CHAIN_TOL[dtype]
                  and srel <= stol and got == want)
            line = (f"K5 osa_block {str(dtype)[6:]} 6x{h}x{w} {c0}->5x{ch}"
                    f"->{cout}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                    f"(tol {CHAIN_TOL[dtype]:.0e}), sums rel err {srel:.3e} "
                    f"(tol {stol:.0e}); launches K5 / chain tile / K4 / K4 "
                    f"wgmma {got} (want {want})")
            if dtype == torch.bfloat16:
                del ref, ref_sums
                kern = lambda: pallas_osa_block.osa_block_fused(
                    *args, conv_kmajor=wks)
                if parent is not None:
                    ms, old_ms, text = in_turns(kern, lambda: parent_osa_block(
                        parent, *args))
                    res["parent_ms"] += per_req_calls * old_ms
                    line += "; " + text
                else:
                    ms = cuda_ms(kern)
                    line += f"; kernel {ms:.3f} ms"
                # the parts: the 5 chain-tile launches, then the reduce
                chain = [x]
                for wk, (sc, bi) in zip(wks, affs):
                    chain.append(pallas_osa_block.conv3x3_kernel(chain[-1], wk,
                                                                 sc, bi))
                chain_ms = cuda_ms(lambda: [pallas_osa_block.conv3x3_kernel(
                    a, wk, sc, bi) for a, wk, (sc, bi) in zip(chain, wks, affs)])
                red_ms = cuda_ms(lambda: pallas_osa.osa_reduce(chain, rws,
                                                               *raff))
                # the default path's chain: cuDNN bf16 3x3 convs (no affine)
                xs = [a.permute(0, 3, 1, 2) for a in chain[:5]]
                wcs = [w9.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last) for w9 in w9s]
                cudnn_ms = cuda_ms(lambda: [torch.nn.functional.conv2d(
                    a, wc, padding=1) for a, wc in zip(xs, wcs)])
                del xs, wcs, chain
                plain_ms = cuda_ms(lambda: pallas_osa_block.plain_osa_block(
                    *args), iters=3, warmup=1)
                flops = 2.0 * n * h * w * (9 * (c0 * ch + 4 * ch * ch)
                                           + sum(widths) * cout)
                bound, kind = bound_ms(flops, dtype, nbytes(
                    x, *w9s, *rws, *[t for a in affs for t in a], *raff,
                    out, sums))
                res["bound_by"] = kind
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["ms"] += per_req_calls * ms
                res["plain_ms"] += per_req_calls * plain_ms
                res["bound_ms"] += per_req_calls * bound
                per_req["chain"] += per_req_calls * chain_ms
                per_req["reduce"] += per_req_calls * red_ms
                per_req["cudnn_chain"] += per_req_calls * cudnn_ms
                line += (f"; chain tiles {chain_ms:.3f} ms + reduce (K4) "
                         f"{red_ms:.3f} ms, cuDNN 3x3 chain {cudnn_ms:.3f} ms; "
                         f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms by "
                         f"{kind}")
            print(line + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"K5 {dtype} 6x{h}x{w} disagrees with "
                                     f"its plain version ({rel}, sums {srel})"
                                     f" or took the wrong tiles ({got})")
            del x, w9s, rws, out, sums, args, wks
    print(f"K5 per request on the bfloat16 path (16 calls: 80 chain-tile "
          f"launches + 16 K4): kernel {res['ms']:.3f} ms (chain tiles "
          f"{per_req['chain']:.3f} + reduce {per_req['reduce']:.3f}), plain "
          f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms"
          + (f", parent K5 {res['parent_ms']:.3f} ms (kernel / parent "
             f"{res['ms'] / res['parent_ms']:.3f})" if parent else "")
          + f"; the default path's cost for the same blocks: cuDNN bf16 3x3 "
          f"chain {per_req['cudnn_chain']:.3f} ms + K4 "
          f"{per_req['reduce']:.3f} ms = "
          f"{per_req['cudnn_chain'] + per_req['reduce']:.3f} ms (no single "
          f"PyTorch call computes an OSA block)")
    return res


def k6_case(g, dtype, h, w, cin, cm, cout, ds):
    """Seeded inputs of one K6 call at N = 6: x, the JAX-layout kernels
    (w1, w2, w3), their affines and the downsample's as keywords."""
    x = torch.randn(6, h, w, cin, device="cuda", generator=g).to(dtype)
    k = lambda *sh: (torch.randn(*sh, device="cuda", generator=g)
                     / math.sqrt(sh[0] * sh[1] * sh[2])).to(dtype)
    ws = (k(1, 1, cin, cm), k(3, 3, cm, cm), k(1, 1, cm, cout))
    affs = (_affine(g, cm), _affine(g, cm), _affine(g, cout))
    kw = dict(wd=k(1, 1, cin, cout), affd=_affine(g, cout)) if ds else {}
    return x, ws, affs, kw


def bottleneck_entry(lib, x, ws, affs, wd=None, affd=None):
    """The bfloat16 K6 of ``lib`` (this build's or the parent's) on weights
    prepared as its wrapper prepares them (before the timing): where the
    library has them, its three Hopper-tile entries on the K-major copies;
    else its one entry ``bottleneck_bf16`` (three conv_tile.cuh kernels) on
    [Cin, Cm], [3, 3, Cm, Cm], [Cm, Cout] and [Cin, Cout] weights.
    Returns a function of no arguments that runs it."""
    from transcar_tpu_torch.ops import pallas_bottleneck

    n, h, w, cin = x.shape
    cm, cout = ws[0].shape[-1], ws[2].shape[-1]
    vp = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    h1 = torch.empty((n, h, w, cm), dtype=x.dtype, device="cuda")
    h2, out = torch.empty_like(h1), torch.empty((n, h, w, cout),
                                                 dtype=x.dtype, device="cuda")
    (s1, b1), (s2, b2), (s3, b3) = affs
    sd, bd = affd if affd is not None else (None, None)
    if hasattr(lib, "bottleneck_conv1_bf16_wgmma"):
        ks = pallas_bottleneck.kmajor_weights(*ws, wd)

        def run():
            return (lib.bottleneck_conv1_bf16_wgmma(
                        vp(x), cin, vp(ks[0]), vp(s1), vp(b1), vp(h1), n, h, w,
                        cm, stream())
                    or lib.bottleneck_conv2_bf16_wgmma(
                        vp(h1), cm, vp(ks[1]), vp(s2), vp(b2), vp(h2), n, h, w,
                        stream())
                    or lib.bottleneck_conv3_bf16_wgmma(
                        vp(h2), cm, vp(ks[2]), vp(s3), vp(b3), vp(x), cin,
                        vp(ks[3]), vp(sd), vp(bd), vp(out), n, h, w, cout,
                        stream()))
    else:
        m = lambda t: t.reshape(t.shape[-2], t.shape[-1]).contiguous()
        pw = (m(ws[0]), ws[1].contiguous(), m(ws[2]),
              None if wd is None else m(wd))

        def run():
            return lib.bottleneck_bf16(
                vp(x), cin, cm, cout, vp(pw[0]), vp(s1), vp(b1), vp(pw[1]),
                vp(s2), vp(b2), vp(pw[2]), vp(s3), vp(b3), vp(pw[3]), vp(sd),
                vp(bd), vp(h1), vp(h2), vp(out), n, h, w, stream())

    def checked():
        rc = run()
        if rc != 0:
            raise RuntimeError(f"K6 entries: CUDA error {rc}")
        return out
    return checked


def phase_k6(parent=None) -> dict:
    """K6 at the 3 R101 stride-1 non-DCN bottleneck shapes, bfloat16 on
    the Hopper tile (K-major weights as the model caches them) and float32
    on the first tile; per request of ``transcar_r101`` with
    ``block_impl=fused`` (6 calls) with its three device kernels timed
    apart, beside cuDNN's bf16 convolutions of the same shapes (a
    reference line) and the parent commit's K6 (``parent``) when given,
    both timed through their bare entries."""
    from transcar_tpu_torch.ops import kernel_lib, pallas_bottleneck

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(6)
    own = own_library()
    res = _kernel_result()
    res["parent_ms"] = 0.0 if parent is not None else None
    per_req = {"conv1": 0.0, "conv2": 0.0, "conv3": 0.0, "cudnn": 0.0,
               "wrapper": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in R101_K6:
            h, w, cin, cm, cout, ds, n_req = shape
            x, ws, affs, kw = k6_case(g, dtype, *shape[:6])
            ks = pallas_bottleneck.kmajor_weights(*ws, kw.get("wd"),
                                                  dtype=dtype)
            args = (x, ws[0], affs[0], ws[1], affs[1], ws[2], affs[2])
            before = pallas_bottleneck.wgmma_launches
            out = pallas_bottleneck.bottleneck_fused(*args, **kw, kmajor=ks)
            took = pallas_bottleneck.wgmma_launches - before
            ref = pallas_bottleneck.plain_bottleneck(*args, **kw)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            want = int(dtype == torch.bfloat16)
            ok = math.isfinite(rel) and rel <= CHAIN_TOL[dtype] and took == want
            line = (f"K6 bottleneck {str(dtype)[6:]} 6x{h}x{w} {cin}->{cm}->"
                    f"{cout}{' +downsample' if ds else ''} "
                    f"({'wgmma tile' if took else 'wmma tile'}): max_abs_err "
                    f"{err:.3e} max_rel_err {rel:.3e} (tol "
                    f"{CHAIN_TOL[dtype]:.0e})")
            if dtype == torch.bfloat16:
                del ref
                kern = bottleneck_entry(own, x, ws, affs, kw.get("wd"),
                                        kw.get("affd"))
                if parent is not None:
                    ms, old_ms, text = in_turns(kern, bottleneck_entry(
                        parent, x, ws, affs, kw.get("wd"), kw.get("affd")))
                    res["parent_ms"] += n_req * old_ms
                    line += "; " + text
                else:
                    ms = cuda_ms(kern)
                    line += f"; kernel {ms:.3f} ms"
                # the path the model calls: the wrapper on the K-major
                # copies it caches (unusable copies raise there)
                wrap_ms = cuda_ms(lambda: pallas_bottleneck.bottleneck_fused(
                    *args, **kw, kmajor=ks))
                per_req["wrapper"] += n_req * wrap_ms
                line += f", through the wrapper {wrap_ms:.3f} ms"
                # the three device kernels apart
                f32 = [t.float().contiguous() for a in affs for t in a]
                fd = [t.float().contiguous() for t in kw["affd"]] if ds else []
                h1 = pallas_bottleneck.conv1_kernel(x, ks[0], *f32[:2])
                h2 = pallas_bottleneck.conv2_kernel(h1, ks[1], *f32[2:4])
                parts = [cuda_ms(lambda: pallas_bottleneck.conv1_kernel(
                             x, ks[0], *f32[:2])),
                         cuda_ms(lambda: pallas_bottleneck.conv2_kernel(
                             h1, ks[1], *f32[2:4])),
                         cuda_ms(lambda: pallas_bottleneck.conv3_kernel(
                             h2, ks[2], *f32[4:], x, ks[3], *fd))]
                # the reference line: cuDNN's bf16 convolutions of the same
                # shapes (1x1, 3x3, 1x1 and the 1x1 downsample), the GEMMs
                # without their epilogues
                cl = lambda t: t.contiguous(memory_format=torch.channels_last)
                xc, h1c, h2c = (t.permute(0, 3, 1, 2) for t in (x, h1, h2))
                wc = [cl(t.permute(3, 2, 0, 1)) for t in
                      (*ws, *([kw["wd"]] if ds else []))]
                cudnn_ms = cuda_ms(lambda: [
                    F.conv2d(xc, wc[0]), F.conv2d(h1c, wc[1], padding=1),
                    F.conv2d(h2c, wc[2])] + (
                        [F.conv2d(xc, wc[3])] if ds else []))
                del xc, h1c, h2c, wc, h1, h2
                plain_ms = cuda_ms(lambda: pallas_bottleneck.plain_bottleneck(
                    *args, **kw), iters=5, warmup=1)
                flops = 2.0 * 6 * h * w * (cin * cm + 9 * cm * cm + cm * cout
                                           + (cin * cout if ds else 0))
                extra = [kw["wd"], *kw["affd"]] if ds else []
                bound, kind = bound_ms(flops, dtype, nbytes(
                    x, *ws, *[t for a in affs for t in a], *extra, out))
                res["bound_by"] = kind
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["ms"] += n_req * ms
                res["plain_ms"] += n_req * plain_ms
                res["bound_ms"] += n_req * bound
                for key, t in zip(("conv1", "conv2", "conv3"), parts):
                    per_req[key] += n_req * t
                per_req["cudnn"] += n_req * cudnn_ms
                line += (f"; conv1 {parts[0]:.3f} + conv2 {parts[1]:.3f} + "
                         f"conv3 {parts[2]:.3f} ms, cuDNN bf16 convs (no "
                         f"epilogues) {cudnn_ms:.3f} ms, plain {plain_ms:.3f} "
                         f"ms, bound {bound:.3f} ms by {kind} (kernel at "
                         f"{bound / ms:.0%} of it)")
            print(line + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"K6 {dtype} 6x{h}x{w} disagrees with "
                                     f"its plain version ({rel}) or took the "
                                     f"wrong tile ({took})")
            del x, ws, out, args, kw, ks
    print(f"K6 per request on the bfloat16 path (6 calls, wgmma tile): "
          f"kernel {res['ms']:.3f} ms (through the wrapper "
          f"{per_req['wrapper']:.3f}; conv1 {per_req['conv1']:.3f} + conv2 "
          f"{per_req['conv2']:.3f} + conv3 {per_req['conv3']:.3f}), plain "
          f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms"
          + (f", parent K6 {res['parent_ms']:.3f} ms (kernel / parent "
             f"{res['ms'] / res['parent_ms']:.3f})" if parent else "")
          + f"; reference: cuDNN bf16 1x1 / 3x3 / 1x1 (+ 1x1 downsample) "
          f"convs of the same shapes {per_req['cudnn']:.3f} ms (no single "
          f"PyTorch call computes a bottleneck)")
    log = kernel_lib.library_path().with_suffix(".log").read_text()
    print("K6 tile ptxas -v: " + " | ".join(
        ln for ln in ptxas_lines(log) if ln.startswith("bottleneck_")
        and "wgmma" in ln))
    return res


def _zero_counts() -> None:
    from transcar_tpu_torch.ops import (pallas_attention, pallas_bottleneck,
                                        pallas_dcn, pallas_osa,
                                        pallas_osa_block)

    from transcar_tpu_torch.ops import pallas_msdeform

    pallas_dcn.launches = pallas_dcn.backward_launches = 0
    pallas_dcn.wgmma_launches = 0
    pallas_attention.launches = pallas_attention.mma_launches = 0
    pallas_osa.launches = 0
    pallas_osa.wgmma_launches = 0
    pallas_osa_block.launches = pallas_bottleneck.launches = 0
    pallas_osa_block.wgmma_launches = pallas_bottleneck.wgmma_launches = 0
    pallas_msdeform.launches = pallas_msdeform.group_launches = 0
    pallas_msdeform.backward_taps_launches = 0
    pallas_msdeform.backward_taps_group_launches = 0
    pallas_msdeform.backward_value_launches = 0
    pallas_msdeform.backward_value_group_launches = 0


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
    from transcar_tpu_torch.ops import pallas_attention, pallas_osa

    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    got = {k: rec["kernel_launches"][k] for k in per_req}
    want = {k: v * rec["requests"] for k, v in per_req.items()}
    wgmma = pallas_osa.wgmma_launches
    k2_mma = pallas_attention.mma_launches
    valid = _check_outputs("vovnet slice", out, cfg)
    print(f"vovnet slice {preset} 6x928x1600 bs1 (V-99-eSE bf16 backbone, "
          f"FPN from stage 2, fp32 head): {rec['requests']} requests, "
          f"launches {got} (want {want}), K4 on the wgmma tile {wgmma} of "
          f"{got['osa_reduce']}, K2 on the mma kernel {k2_mma} of "
          f"{got['masked_attention']}; outputs finite; decode {valid}/300 "
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
    if k2_mma != got["masked_attention"]:
        missed = got["masked_attention"] - k2_mma
        raise AssertionError(f"vovnet slice: {missed} K2 launches missed "
                             "the mma kernel")
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
        bf16 = int(dtype == "bfloat16")
        want = (16, 80 * bf16, 16 * bf16, 16 * bf16)
        with torch.inference_mode():
            _zero_counts()
            fused = nets["fused"](x)
            torch.cuda.synchronize()
            counts = (pallas_osa_block.launches,
                      pallas_osa_block.wgmma_launches, pallas_osa.launches,
                      pallas_osa.wgmma_launches)
            default = nets["pallas"](x)
            k4 = pallas_osa.launches - counts[2]
            if counts != want or k4 != 16:
                raise AssertionError(
                    f"K5 path launches K5 / chain tile / K4 / K4 wgmma "
                    f"{counts}, K4 path K4 {k4}; want {want} and 16")
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
        print(f"K5 path VoVNet-99 {dtype} 6x3x928x1600: launches K5 / chain "
              f"tile / K4 reduce / K4 on the wgmma tile {counts}; "
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

    from transcar_tpu_torch.ops import pallas_bottleneck, pallas_dcn

    preset, fused = "transcar_r101", "model.backbone.block_impl=fused"
    per_req = {"bottleneck": 6, "dcn_forward": 26, "masked_attention": 3}
    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3",
                              "--cfg-options", fused])
    k1_wgmma = pallas_dcn.wgmma_launches
    k6_wgmma = pallas_bottleneck.wgmma_launches
    got = {k: rec["kernel_launches"][k] for k in per_req}
    want = {k: v * rec["requests"] for k, v in per_req.items()}
    valid = _check_outputs("K6 path", out, get_preset(preset))
    print(f"K6 path {preset} block_impl=fused 6x928x1600 bs1: launches {got}"
          f" (want {want}), K1 on the wgmma tile {k1_wgmma} of "
          f"{got['dcn_forward']}, K6 on the wgmma tile {k6_wgmma} of "
          f"{got['bottleneck']}; outputs finite; decode {valid}/300 valid "
          f"boxes")
    if got != want:
        raise AssertionError(f"K6 path launches {got} != {want}")
    if k6_wgmma != got["bottleneck"]:
        raise AssertionError(f"K6 path: {got['bottleneck'] - k6_wgmma} K6 "
                             "calls missed the wgmma tile")
    if k1_wgmma != got["dcn_forward"]:
        raise AssertionError(f"K6 path: {got['dcn_forward'] - k1_wgmma} K1 "
                             "launches missed the wgmma tile")
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


def own_library():
    """This build's kernel library under a ctypes handle of its own (no
    argtypes set), for timing its entries as the parent's are timed."""
    from transcar_tpu_torch.ops import kernel_lib

    return ctypes.CDLL(str(kernel_lib.build()))


def msdeform_entry(lib, name: str, tensors, value, q: int):
    """A function of no arguments that runs the entry ``name`` of the
    MSDeformAttn kernels in ``lib`` (this build's or the parent's) on
    ``tensors`` (pointers, in the entry's order) at the pillar shapes
    (batch 1, Q = ``q``, 8 heads of 32, 4 levels × 4 points): the bare
    launch, without the wrapper's checks and allocations, whose host time
    would exceed a decoder call's device time."""
    levels = [(ctypes.c_int * 4)(*v) for v in (
        [h for h, _ in BEV_LEVELS], [w for _, w in BEV_LEVELS],
        [sum(h * w for h, w in BEV_LEVELS[:i]) for i in range(4)])]
    fn = getattr(lib, name)

    def run():
        rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors), 1,
                value.shape[1], q, 8, 32, 4, 4, *levels,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return run


def group_entry(lib, name: str) -> str:
    """The lane-group form of the MSDeformAttn entry ``name`` where ``lib``
    has one (a parent commit's library may not), else ``name``."""
    group = name.replace("_f32", "_group_f32")
    return group if hasattr(lib, group) else name


def phase_k7(parent=None) -> dict:
    """K7 at one encoder and one decoder call of the pillar slice, each on
    the lane-group kernel, bit for bit against the first kernel (and the
    parent's K7); per request (2 encoder + 6 decoder launches), beside the
    parent commit's K7 (``parent``) when given, both timed through their
    bare entries."""
    from transcar_tpu_torch.ops import kernel_lib, pallas_msdeform
    from transcar_tpu_torch.ops.msdeform import ms_deform_attn_core

    g = torch.Generator(device="cuda").manual_seed(13)
    own = own_library()
    res = _kernel_result()
    res["bound_by"] = "bytes"
    res["parent_ms"] = 0.0 if parent is not None else None
    s = sum(h * w for h, w in BEV_LEVELS)
    for name, q, per_req, chunk in (("encoder", s, 2, 16384),
                                    ("decoder", 300, 6, 0)):
        value, loc, wgt = msdeform_case(g, q, name == "encoder")
        off_map = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
        before = pallas_msdeform.group_launches
        out = pallas_msdeform.ms_deform_attn(value, BEV_LEVELS, loc, wgt)
        group = pallas_msdeform.group_launches - before
        ref = ms_deform_attn_core(value, BEV_LEVELS, loc, wgt, chunk)
        # the first kernel, and the parent's K7, on the same inputs
        same = {}
        for tag, lib in (("first kernel", own), ("parent", parent)):
            if lib is not None:
                other = torch.empty_like(out)
                msdeform_entry(lib, "msdeform_forward_f32",
                               (value, loc, wgt, other), value, q)()
                same[tag] = torch.equal(out, other)
        torch.cuda.synchronize()
        err, rel = _rel_err(out, ref)
        ok = group == 1 and math.isfinite(rel) and rel <= MSDEFORM_TOL
        scratch = torch.empty_like(out)
        kern = msdeform_entry(own, "msdeform_forward_group_f32",
                              (value, loc, wgt, scratch), value, q)
        if parent is not None:
            ms, old_ms, turns = in_turns(kern, msdeform_entry(
                parent, group_entry(parent, "msdeform_forward_f32"),
                (value, loc, wgt, scratch), value, q))
            res["parent_ms"] += per_req * old_ms
            turns = f" ({turns})"
        else:
            ms, turns = cuda_ms(kern), ""
        wrap_ms = cuda_ms(lambda: pallas_msdeform.ms_deform_attn(
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
              f"points: samples off the map {off_map:.3f}; lane-group kernel "
              f"{group} of 1; max_abs_err {err:.3e} max_rel_err {rel:.3e} "
              f"(tol {MSDEFORM_TOL:.0e} of max|plain|); bit for bit "
              + ", ".join(f"with the {k} {v}" for k, v in same.items())
              + f"; kernel {ms:.4f} ms{turns} (through the wrapper "
              f"{wrap_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms by {kind} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K7 {name} disagrees with its plain "
                                 f"version (rel err {rel}) or missed the "
                                 f"lane-group kernel ({group})")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ms"] += per_req * ms
        res["plain_ms"] += per_req * plain_ms
        res["bound_ms"] += per_req * bound
        if kind == "operations":
            res["bound_by"] = kind
        del value, loc, wgt, out, ref
    print(f"K7 per objdgcnn_pillar request (2 encoder + 6 decoder "
          f"launches): kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f}"
          f" ms, bound {res['bound_ms']:.4f} ms"
          + (f", parent K7 {res['parent_ms']:.3f} ms (kernel / parent "
             f"{res['ms'] / res['parent_ms']:.3f})" if parent else "")
          + f" (no single PyTorch call "
          f"computes MSDeformAttn: F.grid_sample samples but does not reduce "
          f"with the weights)")
    log = kernel_lib.library_path().with_suffix(".log").read_text()
    print("K7 lane-group kernel ptxas -v: " + " | ".join(
        ln for ln in ptxas_lines(log)
        if ln.startswith("msdeform_forward_group_kernel")))
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
    from transcar_tpu_torch.ops import pallas_msdeform

    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    group = (pallas_msdeform.group_launches, pallas_msdeform.launches)
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
          f"pillars {rec['pillar_audit']}; K7 on the lane-group kernel "
          f"{group[0]} of {group[1]}")
    if rec["kernel_launches"] != want:
        raise AssertionError(f"pillar slice launches {rec['kernel_launches']}"
                             f" != {want}")
    if group[0] != group[1]:
        raise AssertionError(f"pillar slice: {group[1] - group[0]} K7 "
                             "launches missed the lane-group kernel")
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


def phase_k8_k9(parent=None) -> tuple:
    """K8 and K9 at one encoder and one decoder call of the pillar slice,
    against the plain backward; per call and per step (2 encoder + 6
    decoder launches of each), beside the parent commit's K8 and K9
    (``parent``) when given, both timed through their bare entries; K8
    also through its wrapper, the path the model calls."""
    from transcar_tpu_torch.ops import kernel_lib, pallas_msdeform
    from transcar_tpu_torch.ops.msdeform import ms_deform_attn_backward

    g = torch.Generator(device="cuda").manual_seed(17)
    own = own_library()
    res = {"taps": _kernel_result(), "value": _kernel_result()}
    for r in res.values():
        r["bound_by"] = "bytes"
        r["parent_ms"] = 0.0 if parent is not None else None
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

        before = (pallas_msdeform.backward_taps_group_launches,
                  pallas_msdeform.backward_value_group_launches)
        d_loc, d_attn = taps()
        d_value = dvalue()
        group = (pallas_msdeform.backward_taps_group_launches - before[0],
                 pallas_msdeform.backward_value_group_launches - before[1])
        ref_value, ref_loc, ref_attn = plain()
        torch.cuda.synchronize()
        errs = {k: _rel_err(a, b) for k, (a, b) in {
            "d_attn": (d_attn, ref_attn), "d_loc": (d_loc, ref_loc),
            "d_value": (d_value, ref_value)}.items()}
        ok = group == (1, 1) and all(
            math.isfinite(rel) and rel <= MSDEFORM_BWD_TOL
            for _, rel in errs.values())
        del ref_value, ref_loc, ref_attn
        # the bare entries, timed as the parent's are (the wrappers' host
        # time would pass a decoder call's device time); K9 with the
        # zero-fill of d_value that its wrapper makes
        tensors = (value, loc, wgt, d_out, torch.empty_like(d_loc),
                   torch.empty_like(d_attn))
        dv = torch.empty_like(d_value)
        runs = {}
        for tag, lib in (("kernel", own), ("parent", parent)):
            if lib is None:
                continue
            run_value = msdeform_entry(
                lib, group_entry(lib, "msdeform_backward_value_f32"),
                (loc, wgt, d_out, dv), value, q)
            runs[tag] = (msdeform_entry(
                lib, group_entry(lib, "msdeform_backward_taps_f32"), tensors,
                value, q), lambda run=run_value: (dv.zero_(), run()))
        if parent is not None:
            ms_taps, old_taps, t_taps = in_turns(runs["kernel"][0],
                                                 runs["parent"][0])
            ms_value, old_value, t_value = in_turns(runs["kernel"][1],
                                                    runs["parent"][1])
            t_taps, t_value = f" ({t_taps})", f" ({t_value})"
        else:
            ms_taps, ms_value = (cuda_ms(f) for f in runs["kernel"])
            old_taps = old_value = 0.0
            t_taps = t_value = ""
        del tensors, dv, runs
        wrap_ms = cuda_ms(taps)
        wrap_value_ms = cuda_ms(dvalue)
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
              + f" (tol {MSDEFORM_BWD_TOL:.0e} of max|plain|); K8 on the "
              f"lane-group kernel {group[0]} of 1, K9 {group[1]} of 1; per "
              f"call K8 {ms_taps:.4f} ms{t_taps} (through the wrapper "
              f"{wrap_ms:.4f} ms; bound {b_taps:.4f} ms by {k_taps}), K9 "
              f"{ms_value:.4f} ms{t_value} (through the wrapper "
              f"{wrap_value_ms:.4f} ms; bound {b_value:.4f} ms by "
              f"{k_value}); per step ({per_step} calls) K8 "
              f"{per_step * ms_taps:.3f} ms, K9 {per_step * ms_value:.3f} ms"
              + (f", parent K8 {per_step * old_taps:.3f} ms, parent K9 "
                 f"{per_step * old_value:.3f} ms" if parent else "")
              + f"; plain backward (all three gradients) {plain_ms:.3f} ms "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K8/K9 {name} disagree with the plain "
                                 f"backward ({errs}) or missed the "
                                 f"lane-group kernels ({group})")
        for key, ms, old_ms, bound, kind, err in (
                ("taps", ms_taps, old_taps, b_taps, k_taps,
                 max(errs["d_attn"][0], errs["d_loc"][0])),
                ("value", ms_value, old_value, b_value, k_value,
                 errs["d_value"][0])):
            r = res[key]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"] += per_step * ms
            r["plain_ms"] += per_step * plain_ms
            r["bound_ms"] += per_step * bound
            if parent is not None:
                r["parent_ms"] += per_step * old_ms
            if kind == "operations":
                r["bound_by"] = kind
        del value, loc, wgt, d_out, d_loc, d_attn, d_value
        torch.cuda.empty_cache()
    ratio = lambda key: (f" (parent {res[key]['parent_ms']:.3f} ms, kernel / "
                         f"parent {res[key]['ms'] / res[key]['parent_ms']:.3f})"
                         if parent else "")
    print(f"K8 / K9 per objdgcnn_pillar train step (2 encoder + 6 decoder "
          f"launches each): K8 {res['taps']['ms']:.3f} ms{ratio('taps')} "
          f"(bound {res['taps']['bound_ms']:.4f} ms), K9 "
          f"{res['value']['ms']:.3f} ms{ratio('value')} (bound "
          f"{res['value']['bound_ms']:.4f} ms); the plain backward computes "
          f"all three gradients in one pass, {res['taps']['plain_ms']:.3f} "
          f"ms, and stands in both rows (no single PyTorch call computes the "
          f"MSDeformAttn backward)")
    log = kernel_lib.library_path().with_suffix(".log").read_text()
    print("K8 / K9 lane-group kernels ptxas -v: " + " | ".join(
        ln for ln in ptxas_lines(log)
        if ln.startswith(("msdeform_backward_taps_group_kernel",
                          "msdeform_backward_value_group_kernel"))))
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
    group = (pallas_msdeform.group_launches,
             pallas_msdeform.backward_taps_group_launches,
             pallas_msdeform.backward_value_group_launches)
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
          f"(want {want}: K7, K8, K9 {per_step} per step), on the "
          f"lane-group kernels K7 {group[0]} of {counts[0]}, K8 {group[1]} of "
          f"{counts[1]}, K9 {group[2]} of {counts[2]}; loss total first "
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
    if group != counts:
        raise AssertionError(f"pillar train: K7 / K8 / K9 launches {counts}, "
                             f"on the lane-group kernels {group}")
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
                         "it too and time its K1, K3, K2, K4, K5, K6, K7, K8 "
                         "and K9 in turns with these (their phases)")
    ap.add_argument("--variants", default=None,
                    choices=(*VARIANT_KINDS, "all"),
                    help="instead of the phases: build and time the knock-out "
                         "variants of the K1, K2, K5, K6, K7, K8 or K9 "
                         "kernels (VARIANTS), then exit")
    args = ap.parse_args(argv)
    smi = phase_device()
    if args.variants:
        phase_variants(VARIANT_KINDS if args.variants == "all"
                       else [args.variants], smi)
        return
    phase_build()
    parent = parent_library(args.parent_csrc) if args.parent_csrc else None
    k1 = phase_k1(parent)
    k3 = phase_k3(parent)
    k2 = phase_k2(parent)
    launches = phase_slice(smi)
    train = phase_train(smi)
    phase_train_check()
    launches["dcn_backward"] = train["detr3d_r101"]["launches"][1]
    k4 = phase_k4(parent)
    k5 = phase_k5(parent)
    k6 = phase_k6(parent)
    launches["osa_reduce"] = phase_vovnet_slice(smi)["osa_reduce"]
    launches["osa_block"] = phase_k5_path(smi)
    launches["bottleneck"] = phase_k6_path(smi)
    phase_vovnet_train(smi)
    k7 = phase_k7(parent)
    launches["msdeform_forward"] = phase_pillar(smi)
    k8, k9 = phase_k8_k9(parent)
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
                        "library_ms": res["library_ms"],
                        "parent_ms": res.get("parent_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
