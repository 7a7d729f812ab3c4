"""Smoke test of the PyTorch/CUDA port (``transcar_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

``--parent-csrc DIR`` also builds an earlier commit's kernel sources (for
example ``git archive <commit> transcar_tpu_torch/csrc`` unpacked under
the git-ignored ``transcar_tpu_torch/build/``) and times its K1, K3, K2,
K4, K5, K6, K7, K8 and K9 in turns with these (parent, kernel, kernel,
parent) in phases 3, 4, 5, 8, 13 and 15, and its int8 conv, if it has
one, in phase 22; the summary line then carries each one's
``parent_ms``.  ``--variants k1|k2|k5|k6|k7|k8|k9|int8|all`` runs
none of the phases: it builds each knock-out variant of the K1 / K2 / K5
/ K6 / K7 / K8 / int8 wgmma kernels and of K9's gather in ``VARIANTS`` (a copy of their
sources under ``transcar_tpu_torch/build/variants/`` with its patches)
and prints its time per request or step at the main path's shapes (and
K2's error against its plain version).

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
     and as float32 FMAs, and the parent's K2 with its error; the host µs
     a call through the registered op (``torch.ops.transcar.
     masked_attention``, with and without inference mode) against the
     bare wrapper it dispatches to;
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
     the Hopper tile; one Hungarian matching launch), which parameters
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
     loss, camera frozen, no kernel launches but one Hungarian matching a
     step (training takes the plain OSA tail, as in JAX), ms/step and
     peak memory;
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
     inputs and a random output gradient, K8 on its lane-group kernel and
     K9 (a gather by target) launched twice, bit for bit; per call and per
     step, and the ``-Xptxas -v`` lines of K8's lane-group kernel and K9's
     kernels;
 16. ``objdgcnn_pillar`` training through ``benchmark --train`` at the
     same width (dropout 0.1, batch statistics, clip 35, AdamW with the
     VFE and SECOND at lr × 0.1): 8 K7 + 8 K8 + 8 K9 launches per step
     (K7 and K8 on their lane-group kernels), one Hungarian matching and no
     other kernel, finite losses, trainable elements and BN running
     statistics moved, ms/step and peak memory; then one float32 step
     with one decoder layer and dropout 0, kernel path against plain path
     (gradients per leaf);
 17. the ObjDGCNN voxel slice through ``benchmark objdgcnn_voxel``:
     270 000 real points, 90 000 voxels of 0.1 × 0.1 × 0.2 m on the
     (41, 1024, 1024) grid, the float32 gather encoder (plain PyTorch:
     the TPU ran it as XLA, with no Pallas kernel), bfloat16 SECOND and
     FPN, float32 head; 8 K7 launches per request (all on the lane-group
     kernel) and no other kernel, finite outputs and decode, samples/s,
     peak memory and the ``voxel_audit`` (voxels kept, z layers reached,
     sites before and after each downsample's cap); device ms by layer;
     float32 with one decoder layer, kernel path against plain path; then
     the dense encoder (bfloat16 ``conv3d`` on the full grid, no cap),
     held finite and timed, with its peak memory;
 18. ``objdgcnn_voxel`` training through ``benchmark --train`` at the
     same width: 8 K7 + 8 K8 + 8 K9 launches per step (K7 and K8 on
     their lane-group kernels), one Hungarian matching and no other kernel,
     finite losses, trainable
     elements (the middle encoder's among them) and BN running
     statistics moved, ms/step and peak memory; then, as for the pillar,
     one float32 step with one decoder layer and dropout 0, kernel path
     against plain path (gradients per leaf), at the voxel model's own
     BEV levels (128² / 64² / 32² / 16², 21 760 encoder queries);
 19. no host sync: one warm batch-1 serving request of ``transcar_r101``
     and of ``transcar_vovnet_trainval`` under
     ``torch.cuda.set_sync_debug_mode("error")``, after a positive control
     (a pageable host-to-device copy must raise), the same reported for
     ``objdgcnn_pillar`` and ``objdgcnn_voxel``, and the warm voxel
     middle encoder alone on its voxelized inputs (asserted); then one
     warm train step at full width, batch 1, of ``transcar_r101`` and
     ``detr3d_r101`` (asserted: the matching runs on the card) and of
     ``objdgcnn_pillar`` and ``objdgcnn_voxel`` (reported, with where a
     sync was made), after a second positive control (the host matching,
     ``hungarian_match_host``, must raise);
 20. the data pipeline, checkpoints, train loop, eval hook and the train
     / test CLIs (``cli.train``, ``cli.test``, called in-process) on a
     nuScenes-layout fixture written to a temporary directory
     (:func:`write_fixture`, :func:`write_reference_pth`): the host's
     JPEG decode and radar featurizer routes (each asserted against what
     the host offers), the camera loader's host ms a sample (decode,
     radar tokens, the rest) and its wire bytes, ``normalize_batch_images``
     on the card against the CPU; ``detr3d_r101`` (2 steps, photometric
     on the uint8 wire), ``transcar_r101`` warm-started from the reference
     ``.pth`` (6 steps, a traced window, the eval hook on the 2 val
     samples), its resume to step 7, ``cli.test`` on the hook's
     checkpoint (equal to the hook's rows), and ``objdgcnn_pillar`` (2
     steps and the hook on one sample); launches per run against the
     wants, finite losses, ms a step, the loader wait, peak memory and the
     traced window's device idle share; then test-time augmentation,
     ``cli.test --aug-test`` on the hook's checkpoint: ``identity`` alone
     equal to the plain ``cli.test`` bit for bit, (identity, flip) with
     52 K1 + 3 K2 a sample and finite metrics, and the same with
     ``quantize=int8`` (156 int8 convs a sample); then the tools on the
     same fixture and work dirs (:func:`phase_tools`): ``cli.export`` of
     ``transcar_r101`` (the warm-started checkpoint),
     ``transcar_vovnet_trainval``, ``objdgcnn_pillar`` (its checkpoint)
     and the opt-in serving configurations (R101 int8, VoVNet
     ``osa_reduce_impl=fused``, R101 ``block_impl=fused``) at full width,
     six processes side by side, each ``.pt2`` (weights and the layouts
     derived from them as its state) loaded and run on the card against
     the live eval step (max |Δ| of the decoded outputs 0 and the labels
     equal, for all six, and eager's own repeat bit for bit,
     :data:`EXPORT_EXACT`; exactly eager's launches a request, each on its
     main tile, :data:`EXPORTS`; device kernels a request against eager's;
     ms a request beside eager), ``cli.test --show-dir`` (one PNG a
     sample), the ``parity_check`` capture → compare round trip,
     ``get_flops`` of the six presets at full width and of the opt-in
     configurations beside their twins, ``publish_model`` of the
     warm-started run, ``print_config`` and ``analyze_logs`` on its json
     log;
 21. int8 serving: ``transcar_r101`` and ``transcar_vovnet_trainval`` bs1
     at full width with ``model.backbone.quantize=int8`` through
     ``cli.benchmark``: 78 int8 convs (77 on the wgmma tile, 74 codes and
     60 amax passes) + 26 K1 + 3 K2, and 83 int8 convs (82 on the wgmma
     tile, 83 codes and 17 amax passes) + 16 K4 + 3 K2 a request
     (:data:`INT8_SLICES`), the conv shapes against the architectures,
     FrozenBN folded into every epilogue, finite outputs and decode, ms a
     request and peak memory beside the bf16 path, each FPN level's cosine
     and relative error against the bf16 path (inside the first kernels'
     range), and no host sync in a warm int8 request;
 22. the int8 conv kernel and its quantize passes (``csrc/int8_conv.cu``,
     no TPU counterpart: the JAX package runs this conv in XLA) against
     their plain versions, bit for bit, at every distinct conv shape
     phase 21 ran, with the tile each took: the conv alone and with
     ConvBN's epilogue and amax; timed (:func:`queued_ms`) per shape and per
     request beside the bound, ``torch._int_mm`` over an im2col of the
     same codes, cuDNN's bf16 convolution of the same shape and cuDNN
     plus the module's BN and ReLU passes; the host µs a call of the
     ``transcar::int8_*`` ops against the bare wrappers they dispatch to;
 23. data parallelism, 2 ranks on the one card over gloo (NCCL refuses
     two ranks on one device; ``transcar_tpu_torch/parallel``): a
     ``transcar_r101`` fusion-only step (6 × 928 × 1600, 900 queries,
     1500 radar tokens, batch 1 a rank) and an ``objdgcnn_pillar`` step
     (300 000 points), float32, dropout off, one decoder layer, each held
     to the one-process step of the same global batch of 2 (the summed
     gradients before the clip and their norm to ``DP_GRAD_TOL``; losses,
     and parameters and BN running statistics to rtol = atol = 1e-4) with
     the ranks bit for bit equal; then both at full depth in bfloat16, ms
     a step a rank, launches a rank a step (26 K1; 8 each of K7-K9; one
     Hungarian matching), peak memory a rank and the gradient
     all-reduce's ms;
 24. the same data-parallel code over NCCL at world size 1: a float32
     pillar step's losses, BatchNorm running statistics, summed gradients
     and updated parameters bit for bit those of the step with no group,
     which run twice repeats itself bit for bit;
 25. the head split over 2 ranks (gloo, the same group): a
     ``transcar_r101`` eval forward at full width (one decoder layer)
     against the replicated forward, K2 on 4 of 8 heads (3 launches a
     rank, each held to its plain version at [1, 4, 900, 32] × 1500
     tokens), and a train step (dropout on) against the replicated step
     at the JAX dry run's tolerances and its gradients to ``TP_GRAD_TOL``;
 26. camera sharding: the ``transcar_r101`` eval forward at full width
     with the card listed 2, 3 and 6 times (26 K1 a camera group), in
     float32 and bfloat16, bit for bit the unsharded forward whose
     backbone and FPN take as many cameras at a time (cuDNN picks its
     algorithms by batch size), and float32 within 1e-3 of the plain
     unsharded forward; and, in phase 20, ``cli.test --shard-cameras``
     taking the one-device path on one card;
 27. the Hungarian matching kernel (``csrc/hungarian.cu``, replacing the
     JAX package's on-device solver, ``transcar_tpu/ops/hungarian.py``)
     against its plain version on the card, matches, validity and scans
     identical, and against scipy's optimum of the sanitized costs, at
     the train steps' problems (:data:`HUNGARIAN_CASES`: 3 and 6 × 900
     queries × 32 gt slots with 7 gts, 6 × 300 × 32, a nuScenes-like
     6 × 900 × 128 with 128 / 64 / 40 / 7 / 1 / 0 gts, tied integer
     costs and non-finite costs at 6 × 900 × 32 with 32 / 20 / 7 / 7 / 1
     / 0 gts); per call the kernel's time (queued behind a spin), its
     Dijkstra scans (all, and the longest problem's, which sets the time:
     the blocks run side by side) and µs a scan of the longest problem,
     the bound, the plain version's time and the host solve's (scipy
     with its two copies);
 28. repeat: the port gives the same bits run after run, as the JAX
     package's XLA programs do (every entry point, and this script, set
     PyTorch's deterministic mode, ``core/device.set_deterministic``):
     each serving request of the six presets and of the three opt-in
     configurations (R101 int8, VoVNet ``osa_reduce_impl=fused``, R101
     ``block_impl=fused``) run twice at full width, every raw head output
     and every decoded output compared bit for bit; each preset's train
     step run twice from the same state and batch in its phase's dtypes,
     the losses, every gradient and every parameter and buffer after the
     update compared bit for bit; and K3, K4, K5 and K9 launched twice at
     their phase shapes (phases 4, 8 and 15 make the second launches).
     ``python3 chip_smoke.py --repeat`` runs this phase alone (the build,
     then the kernels twice at one shape each, and the rest as above).

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``; it lists the Hungarian matching after
K1-K9 (with its ``host_ms``, ``scans`` and ``scans_longest``;
``library_ms`` null: no PyTorch call solves an assignment), then the
int8 conv and quantize kernels, with ``"replaces": null`` and a note.
There is no CPU path: without CUDA the script raises.
"""
from __future__ import annotations

import ctypes
import functools
import json
import math
import os
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
# (a few bf16 ulps); in float32 the two differ by summation order (the
# kernel's is fixed: d_x gathered by target, d_W's splits summed in split
# order, so it repeats bit for bit)
DCN_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the spread of the "model" K3 offsets, px (see dcn_backward_case)
MODEL_OFFSET_PX = 2.0
# Published dense peaks of one H100 SXM at 700 W (FLOP/s) and its memory
# rate (bytes/s), for the bound of each kernel's work
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
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
# the next conv (K5, K6).  The channel sums are float32 values summed in
# another order than the plain version's single sum, one fixed order
# (a partial a tile, the partials in tile order), so they repeat bit for
# bit.
CONV_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
CHAIN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
SUMS_TOL = 1e-4
# the K5 path against the K4 path over 16 float32 blocks: the two differ
# by summation order in every conv and reduce, compounded block by block
BACKBONE_TOL = 1e-3
# float32 train step, kernel path vs plain path: loss and gradient norm
# differ by summation order (K3's d_x / d_W sums, the DCN GEMMs); the
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
# (d_value, summed by K9 in the samples' order, the same every run)
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
    from transcar_tpu_torch.ops import counts

    n, h, w, cin = x.shape
    cout = wt.shape[-1]
    flops = (counts.dcn_backward if backward else counts.dcn_forward)(
        n, h, w, cin, cout)
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


#: The kernels of ``csrc/ordered_sum.cuh``'s gather by target (K3, K9).
ORDERED_KERNELS = ("scan_chunks_kernel", "scan_apply_kernel", "fill_kernel",
                   "rank_kernel", "sum_kernel")


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


# Knock-out variants of the K1, K2, K5, K6, K7, K8, K9 and int8 kernels
# (``--variants``):
# name: (sources copied, [(file patched, old text, new text), ...]).  A
# variant that takes out part of the work computes garbage; only its time
# is read.  A patch whose old text is gone raises.  No patch may drop an
# mbarrier wait: a gather that skips its wait on ``empty`` over-arrives the
# ring.
K1_SRC = ("dcn_forward.cu", "dcn_tap.cuh", "hopper_tile.cuh")
K5_SRC = ("osa_block.cu", "osa_wgmma.cuh", "hopper_tile.cuh", "conv_tile.cuh",
          "ordered_sum.cuh")
K6_SRC = ("bottleneck.cu", "osa_wgmma.cuh", "hopper_tile.cuh", "conv_tile.cuh",
          "ordered_sum.cuh")
K7_SRC = ("msdeform_forward.cu", "msdeform_gather.cuh")
K8_SRC = ("msdeform_backward.cu", "msdeform_gather.cuh", "ordered_sum.cuh")
K9_SRC = K8_SRC
K2_SRC = ("masked_attention.cu", "hopper_tile.cuh")
INT8_SRC = ("int8_conv.cu", "osa_wgmma.cuh", "hopper_tile.cuh", "ordered_sum.cuh")
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
        "              hop::mbar_expect_tx(&full[r.stage], (BM + p.b_rows) * ROW);\n"
        "              if constexpr (kConv) {\n"
        "                const int i0 = (mt / p.tiles_w) * (BM / p.bw);\n"
        "                const int j0 = (mt % p.tiles_w) * p.bw;\n"
        "                // tap offset (oy, ox); stride 2: the map of its parity\n"
        "                const int oy = tap / p.kw - p.pad, ox = tap % p.kw - p.pad;\n"
        "                const int sm = (1 << p.sshift) - 1;\n"
        "                hop::tma_load_4d(sa + r.stage * BM * ROW, &p.a[2 * (oy & sm) + (ox & sm)],\n"
        "                                 &full[r.stage], k0, j0 + (ox >> p.sshift),\n"
        "                                 i0 + (oy >> p.sshift), img);\n",
        "              hop::mbar_expect_tx(&full[r.stage], (kConv ? p.b_rows : BM + p.b_rows) * ROW);\n"
        "              if constexpr (kConv) {\n")]),
    "k5 no B loads": (K5_SRC, [(
        "osa_wgmma.cuh",
        "              hop::mbar_expect_tx(&full[r.stage], (BM + p.b_rows) * ROW);\n",
        "              hop::mbar_expect_tx(&full[r.stage], (kConv ? BM : BM + p.b_rows) * ROW);\n"), (
        "osa_wgmma.cuh",
        "                hop::tma_load_3d(sb + r.stage * BN * ROW, &p.b[0], &full[r.stage], k0,\n"
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
    # the gather by target's parts knocked out, each in place of its launch
    "k9 no segment order (the filing's, copied)": (K9_SRC, [(
        "ordered_sum.cuh",
        "  sort_long_kernel<<<4 * sms, kSortThreads, 0, stream>>>(g);\n",
        "  cudaMemcpyAsync(g.sorted, g.keys, g.E * sizeof(unsigned long long),\n"
        "                  cudaMemcpyDeviceToDevice, stream);\n"), (
        "ordered_sum.cuh",
        "  rank_kernel<<<static_cast<unsigned>((static_cast<long long>(g.cells) * 32 + 255) / 256),\n"
        "                256, 0, stream>>>(g);\n", "")]),
    "k9 a warp ranks every segment (no block sort)": (K9_SRC, [(
        "ordered_sum.cuh", "constexpr int kWarpRank = 256;",
        "constexpr int kWarpRank = 1 << 30;")]),
    "k9 a block sorts every segment past 32": (K9_SRC, [(
        "ordered_sum.cuh", "constexpr int kWarpRank = 256;",
        "constexpr int kWarpRank = 32;")]),
    "k9 no sums (the lists alone)": (K9_SRC, [(
        "ordered_sum.cuh", "  if (vec)\n    sum_kernel<4>",
        "  if (C < 0)\n    sum_kernel<4>"), (
        "ordered_sum.cuh", "  else\n    sum_kernel<1>", "  else if (C < 0)\n    sum_kernel<1>")]),
    "int8 base": (INT8_SRC, []),
    "int8 non-persistent (a block a tile)": (INT8_SRC, [(
        "osa_wgmma.cuh",
        "  const int grid = p.tiles < hop::sm_count() ? p.tiles : hop::sm_count();\n",
        "  const int grid = p.tiles;\n")]),
    "int8 64-wide N (Cout tiles of 64)": (INT8_SRC, [(
        "int8_conv.cu", "int s8_tile_n(int Cout, bool conv, bool bf16_out) {\n",
        "int s8_tile_n(int Cout, bool conv, bool bf16_out) {\n"
        "  if (Cout > 0) return 64;\n")]),
    "int8 whole Cout up to 256 (no staged 128-wide tiles above 128)": (
        INT8_SRC, [("int8_conv.cu",
                    "  if (bf16_out && Cout % 128 == 0) return 128;\n", "")]),
    "int8 no epilogue fold (dequantize only)": (INT8_SRC, [(
        "int8_conv.cu", "  p.fold = scale != nullptr;\n  p.relu = relu;\n",
        "  p.fold = 0;\n  p.relu = 0;\n")]),
    "int8 unstaged (every tile stores from the registers)": (INT8_SRC, [(
        "int8_conv.cu", "  const bool staged = p.out_f32 == nullptr;\n",
        "  const bool staged = false;\n")]),
    "int8 each slice waited for (no wgmma group in flight)": (INT8_SRC, [(
        "osa_wgmma.cuh",
        "              hop::wgmma_wait<1>();\n              if (t == 0 && held >= 0)",
        "              hop::wgmma_wait<0>();\n              if (t == 0 && held >= 0)")]),
    "int8 amax pass from the start of x (no L2 reuse by the codes pass)": (
        INT8_SRC, [("int8_conv.cu", "        load8(x + 8 * (n8 - 1 - i), v[u]);\n",
                    "        load8(x + 8 * i, v[u]);\n")]),
}


VARIANT_KINDS = ("k1", "k2", "k5", "k6", "k7", "k8", "k9", "int8")


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
    Hopper-tile entries at the 3 R101 bottleneck shapes, or of K7's or K8's
    lane-group entry or K9's entry at one encoder and one decoder call of the
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
    if kind == "int8":
        from transcar_tpu_torch.ops import int8

        g = torch.Generator(device="cuda").manual_seed(21)
        scratch = torch.zeros(2, dtype=torch.int32, device="cuda")
        amax, scale = torch.empty((), device="cuda"), torch.empty((),
                                                                device="cuda")
        for preset, per in int8_main_shapes().items():
            for (n, cin, h, w, cout, k, stride, pad), per_req in per.items():
                if not int8.takes_wgmma(cin, cout):
                    continue
                ho = (h + 2 * pad - k) // stride + 1
                wo = (w + 2 * pad - k) // stride + 1
                xq = torch.randint(-127, 128, (n, h, w, cin), device="cuda",
                                   generator=g, dtype=torch.int8)
                wq = int8.prepare_weight(torch.randn(
                    cout, cin, k, k, device="cuda", generator=g))
                t = (xq, wq.kmajor, torch.full((), 0.01, device="cuda"),
                     wq.scale, *_affine(g, cout))
                o = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16,
                                device="cuda")
                calls.append((
                    f"{preset} {cin}x{h}x{w}->{cout} {k}x{k}s{stride}",
                    per_req, lambda lib, t=t, o=o, d=(
                        n, h, w, cin, cout, k, k, stride, pad, ho, wo,
                        wq.kmajor.shape[1]): lib.int8_conv_wgmma(
                            *map(vp, t), 1, vp(o), 1, vp(amax), vp(scratch),
                            *d, stream())))
            # the amax + codes passes of each conv input (one a conv)
            inputs = {}
            for (n, cin, h, w, *_), per_req in per.items():
                inputs[(n, cin, h, w)] = inputs.get((n, cin, h, w), 0) + per_req
            for (n, cin, h, w), per_req in inputs.items():
                x = torch.randn(n * h * w * cin, device="cuda",
                                generator=g).bfloat16()
                q = torch.empty(x.shape, dtype=torch.int8, device="cuda")
                calls.append((
                    f"{preset}-quantize {n}x{cin}x{h}x{w}", per_req,
                    lambda lib, x=x, q=q: lib.int8_amax(
                        vp(x), 1, ctypes.c_longlong(x.numel()), vp(amax),
                        vp(scratch), stream()) or lib.int8_codes(
                        vp(x), 1, ctypes.c_longlong(x.numel()), vp(amax),
                        vp(q), vp(scale), stream())))
        return calls
    if kind in ("k7", "k8", "k9"):
        from transcar_tpu_torch.ops import kernel_lib

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
            else:       # the gather's workspace, as the wrapper sizes it
                work = kernel_lib.workspace(
                    "msdeform_backward_value_workspace", "cuda", 1, s, q, 8,
                    4, 4)
                t = (loc, wgt, d_out, torch.empty_like(value), work,
                     kernel_lib.zeroed_scratch("cuda", s * 8))
                call = (lambda lib, t=t, d=shape:
                        lib.msdeform_backward_value_f32(*map(vp, t), *d,
                                                        stream()))
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
    "k8", "k9", "int8"): ms per request or step (CUDA events; K2's and the
    int8 conv's launches queued behind a spin kernel) at the main path's
    shapes, by offsets for K1, by call for K7-K9 and by preset for int8
    (the wgmma tile's bare entry with the epilogue fold), timed in turns with the unpatched kernel
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
                timer = (queued_ms if kind == "k2" else _int8_timer
                         if kind == "int8"
                         else lambda f: cuda_ms(f, iters=iters))
                var = lambda: call(lib)
                turns = [timer(f) for f in (lambda: call(base), var, var,
                                            lambda: call(base))]
                ms, base_ms = min(turns[1:3]), min(turns[0], turns[3])
                key = (label.rsplit(" ", 1)[-1] if kind in ("k1", "k6")
                       else label.split(" ", 1)[0]
                       if kind in ("k7", "k8", "k9", "int8") else "all")
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


def repeats(label: str, first, second) -> bool:
    """Record in :data:`REPEATS` whether two launches of a kernel on the
    same inputs gave the same bits (every tensor of ``first`` and
    ``second`` ``torch.equal``); phase 28 prints and asserts the record."""
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    REPEATS[label] = same
    return same


#: label → the kernel's second launch equal to its first, bit for bit
#: (:func:`repeats`), from the phases that already launch it.
REPEATS: dict = {}


def dcn_backward_errors(x, om, wt, d_out, label: str = ""):
    """K3 against its plain version: max |kernel − plain| of d_x,
    d_offset_mask and d_W, each over max |plain|, and the largest
    absolute error; with a ``label``, K3 launched again and its repeat
    recorded (:func:`repeats`)."""
    from transcar_tpu_torch.ops import pallas_dcn

    got = pallas_dcn.backward_kernel(x, om, wt, d_out)
    if label:
        repeats(label, got, pallas_dcn.backward_kernel(x, om, wt, d_out))
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
    """Device ms of K3's two parts apart: (a) d_samp and d_om, then the
    gather of d_x; (b) d_W with its ordered splits."""
    from transcar_tpu_torch.ops import pallas_dcn

    n, h, w, cin = x.shape
    w_t = wt.to(x.dtype).contiguous()
    d_x = torch.empty((n, h, w, cin), dtype=torch.float32, device="cuda")
    d_om = torch.empty_like(om)
    d_w = torch.empty((9 * cin, wt.shape[-1]), dtype=torch.float32,
                      device="cuda")
    return (cuda_ms(lambda: pallas_dcn.backward_data(x, om, w_t, d_out, d_x,
                                                      d_om)),
            cuda_ms(lambda: pallas_dcn.backward_weight(x, om, d_out, d_w)))


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
                label = (f"K3 {str(dtype)[6:]} x[{n},{h},{w},{cin}]->{cout} "
                         f"offsets {offsets}")
                rels, err = dcn_backward_errors(x, om, wt, d_out, label)
                ok = REPEATS[label] and all(
                    math.isfinite(r) and r <= DCN_BWD_TOL[dtype] for r in rels)
                line = (f"K3 dcn backward {str(dtype)[6:]} x[{n},{h},{w},"
                        f"{cin}]->{cout} offsets {offsets}: d_x / d_om / d_W "
                        f"max_rel_err {rels[0]:.3e} / {rels[1]:.3e} / "
                        f"{rels[2]:.3e} (tol {DCN_BWD_TOL[dtype]:.0e} of "
                        f"max|plain|), launched twice: bit for bit "
                        f"{REPEATS[label]}")
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
                                         f"with its plain version ({rels}) "
                                         f"or with its own repeat")
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


def queued_ms(fn, iters: int = 50, warmup: int = 1) -> float:
    """Device ms of ``fn()`` launched ``iters`` times back to back (CUDA
    events): the launches queue up behind a ~10 ms spin kernel
    (``torch.cuda._sleep``), so the host's time per launch (a wrapper's
    checks, ctypes, allocations) stays out of a reading of a short
    kernel, which :func:`cuda_ms` does not ensure.  The reading counts
    only if the start event had not yet run when the host was done
    issuing; else the spin is lengthened and the reading taken again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        paced = start.query()          # the spin ended while the host issued
        torch.cuda.synchronize()
        if not paced:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("queued_ms: the host could not queue the launches "
                       "ahead of the device")


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
    from transcar_tpu_torch.ops import counts

    b, h, nq, hd = qh.shape
    flops = counts.masked_attention(b, h, nq, kh.shape[2], hd)
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
            # through the registered op (the model's and the exported
            # program's route) against the bare wrapper it dispatches to
            with torch.inference_mode():       # as the eval step calls
                op_inference = host_us(wrap)
            host = {"op": host_us(wrap), "op in inference mode": op_inference,
                    "wrapper": host_us(
                        lambda: pallas_attention.kernel(qh, kh, vh, keep)),
                    "entry": host_us(call),
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
                  + f" (op dispatch {host['op'] - host['wrapper']:.2f} µs "
                  f"a call); back to back, no queue ahead: op "
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


def warm_request_syncs(preset: str, encoder_only: bool = False,
                       cfg_options=()) -> list:
    """One warm batch-1 serving request of ``preset`` at full width (or,
    with ``encoder_only``, its middle encoder alone on the request's
    voxelized inputs) under ``torch.cuda.set_sync_debug_mode("error")``;
    the host synchronization it made, if any."""
    from transcar_tpu_torch.cli import benchmark

    args = benchmark.parse_args([preset, "--cfg-options", *cfg_options])
    _, model, batch, _ = benchmark._setup(args, training=False)
    inputs = ([batch["points"], batch["num_points"]] if "points" in batch
              else [batch["images"], batch["lidar2img"],
                    batch.get("radar_tokens")])
    found = []
    with torch.inference_mode():
        if encoder_only:
            inputs = model.voxel_features(*inputs)
            model = model.middle_encoder
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
    ``transcar_vovnet_trainval``) nor in the warm ``objdgcnn_voxel``
    middle encoder; the ObjDGCNN requests are reported."""
    _sync_check_armed()
    reported = ("objdgcnn_pillar", "objdgcnn_voxel")
    for preset in ("transcar_r101", "transcar_vovnet_trainval", *reported):
        found = warm_request_syncs(preset)
        print(f"sync check (set_sync_debug_mode, armed) {preset} warm bs1 "
              f"request: "
              + ("no host sync ok" if not found else f"host syncs {found}")
              + (" (reported only)" if preset in reported else ""))
        if found and preset not in reported:
            raise AssertionError(f"{preset}: a serving request synchronized "
                                 f"with the host: {found}")
    found = warm_request_syncs("objdgcnn_voxel", encoder_only=True)
    print("sync check (set_sync_debug_mode, armed) objdgcnn_voxel middle "
          "encoder (gather, warm, on its voxelized inputs): "
          + ("no host sync ok" if not found else f"host syncs {found}"))
    if found:
        raise AssertionError(f"the voxel middle encoder synchronized with "
                             f"the host: {found}")


def _sync_site(err: BaseException) -> str:
    """The first line of a sync-debug error and the innermost frame of the
    port (or of torch) that raised it, so a report says where to look."""
    import traceback

    frames = traceback.extract_tb(err.__traceback__)
    ours = [f for f in frames if "transcar_tpu_torch" in f.filename]
    at = (ours or frames)[-1]
    return (f"{str(err).splitlines()[0]} at "
            f"{os.path.relpath(at.filename)}:{at.lineno} ({at.name})")


def warm_step_syncs(preset: str) -> list:
    """One warm train step of ``preset`` at full width, batch 1 (as
    ``benchmark --train`` sets it up), under
    ``torch.cuda.set_sync_debug_mode("error")``; the host synchronization
    it made, if any, with where it was made."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.train.step import init_state, train_step

    args = benchmark.parse_args([preset, "--train"])
    cfg, model, batch, _ = benchmark._setup(args, training=True)
    state = init_state(cfg, model, total_steps=2)
    gen = torch.Generator().manual_seed(args.seed + 2)
    train_step(state, batch, gen)                                 # warmup
    torch.cuda.synchronize()
    found = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(state, batch, gen)
    except RuntimeError as e:
        found.append(_sync_site(e))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del state, model, batch
    torch.cuda.empty_cache()
    return found


def phase_step_sync() -> None:
    """No host sync in a warm camera train step (``transcar_r101``,
    ``detr3d_r101``: the matching runs on the card), after the positive
    controls: a pageable copy, and the host matching
    (``hungarian_match_host``), must raise; the ObjDGCNN steps are
    reported."""
    from transcar_tpu_torch.ops import hungarian

    _sync_check_armed()
    cost = torch.rand(6, 900, 32, device="cuda")
    n = torch.full((6,), 7, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hungarian.hungarian_match_host(cost, n)
        caught = None
    except RuntimeError as e:
        caught = _sync_site(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"sync check (armed) hungarian_match_host (the host matching): "
          f"{'raised ok: ' + caught if caught else 'did not raise'}")
    if caught is None:
        raise AssertionError("the sync check did not flag the host matching")
    reported = ("objdgcnn_pillar", "objdgcnn_voxel")
    for preset in ("transcar_r101", "detr3d_r101", *reported):
        found = warm_step_syncs(preset)
        print(f"sync check (set_sync_debug_mode, armed) {preset} warm bs1 "
              f"train step: "
              + ("no host sync ok" if not found else f"host syncs {found}")
              + (" (reported only)" if preset in reported else ""))
        if found and preset not in reported:
            raise AssertionError(f"{preset}: a train step synchronized with "
                                 f"the host: {found}")


#: Phase 27's problems: (name, P problems, Q queries, G gt slots, the gt
#: counts, the costs).  The train steps' (L·B problems; the synthetic
#: batch's 7 gts of 32 slots): ``transcar_r101``'s 3 fusion layers and
#: ``detr3d_r101``'s 6 decoder layers over 900 queries, ObjDGCNN's 6 over
#: 300; a nuScenes-like batch of counts up to the 128-slot pad; integer
#: costs (ties everywhere) and non-finite costs.
HUNGARIAN_CASES = (
    ("transcar_r101", 3, 900, 32, (7,) * 3, "uniform"),
    ("detr3d_r101", 6, 900, 32, (7,) * 6, "uniform"),
    ("objdgcnn", 6, 300, 32, (7,) * 6, "uniform"),
    ("nuScenes-like", 6, 900, 128, (128, 64, 40, 7, 1, 0), "uniform"),
    ("ties", 6, 900, 32, (32, 20, 7, 7, 1, 0), "integer"),
    ("non-finite", 6, 900, 32, (32, 20, 7, 7, 1, 0), "non-finite"),
)
#: The case whose times stand in the kernels line: the ``detr3d_r101``
#: step's problems.
HUNGARIAN_MAIN = "detr3d_r101"
#: The optimum check against scipy (float32 sums of up to ±1e7 costs).
HUNGARIAN_RTOL, HUNGARIAN_ATOL = 1e-6, 1e-3


def _hungarian_costs(g, p: int, q: int, gts: int, kind: str):
    """[P, Q, G] float32 costs on the card: uniform in [0, 10) (a focal
    plus L1 cost's range), integers in [0, 4), or uniform with NaN, ±inf
    and values past the ±1e7 clip (one problem all NaN)."""
    if kind == "integer":
        return torch.randint(0, 4, (p, q, gts), device="cuda",
                             generator=g).float()
    cost = torch.rand(p, q, gts, device="cuda", generator=g) * 10
    if kind == "non-finite":
        cost[0, 3, 2] = float("nan")
        cost[0, 7] = float("inf")
        cost[1, :, 1] = float("-inf")
        holes = torch.rand(q, gts, device="cuda", generator=g) < 0.3
        cost[2][holes] = float("nan")
        cost[3, :5] = 3e9
        cost[4] = float("nan")
    return cost


def _optimum_gap(cost, counts, matched) -> tuple:
    """(real slots distinct and padded ones Q in every problem, the
    largest |matched total − scipy's optimum| over the sanitized costs,
    within HUNGARIAN_RTOL / ATOL)."""
    from scipy.optimize import linear_sum_assignment

    from transcar_tpu_torch.ops.hungarian import sanitize_cost

    p, q, gts = cost.shape
    sane = sanitize_cost(cost).double().cpu().numpy()
    m = matched.cpu().numpy()
    shape_ok, gap, ok = True, 0.0, True
    for i, n in enumerate(counts):
        shape_ok &= bool((m[i, n:] == q).all()
                         and len(set(m[i, :n].tolist())) == n)
        got = sane[i, m[i, :n], list(range(n))].sum()
        rows, cols = linear_sum_assignment(sane[i, :, :n])
        want = sane[i, rows, cols].sum()
        gap = max(gap, abs(got - want))
        ok &= abs(got - want) <= HUNGARIAN_ATOL + HUNGARIAN_RTOL * abs(want)
    return shape_ok, gap, ok


def phase_hungarian(smi: str) -> dict:
    """The matching kernel (``csrc/hungarian.cu``) against its plain
    version on the card at every :data:`HUNGARIAN_CASES` shape (matches,
    validity and scans identical), and against scipy's optimum; timed
    beside its bound, the plain version and the host solve with its two
    copies.  Returns the kernels line's entry of :data:`HUNGARIAN_MAIN`."""
    from transcar_tpu_torch.ops import counts, hungarian

    g = torch.Generator(device="cuda").manual_seed(27)
    out, bad = {}, []
    for name, p, q, gts, gt_counts, kind in HUNGARIAN_CASES:
        cost = _hungarian_costs(g, p, q, gts, kind)
        n = torch.tensor(gt_counts, dtype=torch.int32, device="cuda")
        scans_k = torch.zeros(p, dtype=torch.int32, device="cuda")
        scans_p = torch.zeros(p, dtype=torch.int32, device="cuda")
        mk, vk = hungarian.kernel(cost, n, scans=scans_k)
        mp, vp = hungarian.hungarian_match_plain(cost, n, scans=scans_p)
        torch.cuda.synchronize()
        same = (torch.equal(mk, mp) and torch.equal(vk, vp)
                and torch.equal(scans_k, scans_p))
        err = (mk - mp).abs().max().item()
        shape_ok, gap, opt_ok = _optimum_gap(cost, gt_counts, mk)
        scans, longest = int(scans_k.sum()), int(scans_k.max())
        ms = queued_ms(lambda: hungarian.kernel(cost, n))
        plain_ms = cuda_ms(lambda: hungarian.hungarian_match_plain(cost, n),
                           iters=1, warmup=0)           # warm: the check

        def host():
            hungarian.hungarian_match_host(cost, n)
            torch.cuda.synchronize()

        host_ms = 1e-3 * host_us(host, iters=10)
        bound, by = bound_ms(counts.hungarian_operations(q, scans),
                             torch.float32,
                             counts.hungarian_bytes(q, gts, gt_counts))
        rows = sum(min(c, gts) for c in gt_counts)
        ok = same and shape_ok and opt_ok
        print(f"hungarian {name} P={p} Q={q} G={gts} num_gt={gt_counts} "
              f"({kind} costs): kernel = plain bit for bit (matches, "
              f"validity, scans) {same} (max |diff| {err}); distinct real "
              f"slots and sentinel Q {shape_ok}; matched total - scipy "
              f"optimum max |diff| {gap:.3e} (rtol {HUNGARIAN_RTOL:.0e}, "
              f"atol {HUNGARIAN_ATOL:.0e}); {scans} Dijkstra scans a call "
              f"for {rows} rows, {longest} in its longest problem; kernel "
              f"{ms:.4f} ms a call (queued), {1e3 * ms / max(longest, 1):.3f}"
              f" us a scan of the longest problem; bound {bound:.5f} "
              f"ms by {by}; plain {plain_ms:.2f} ms; host solve (scipy, "
              f"two copies) {host_ms:.3f} ms {'ok' if ok else 'FAIL'} on "
              f"{smi}")
        bad += [] if ok else [name]
        out[name] = {"max_abs_err": float(err), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": None, "parent_ms": None,
                     "host_ms": host_ms, "scans": scans,
                     "scans_longest": longest}
    if bad:
        raise AssertionError(f"hungarian kernel: {bad} disagree with the "
                             "plain version or miss scipy's optimum")
    return out[HUNGARIAN_MAIN]


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
    from transcar_tpu_torch.ops import hungarian, pallas_attention, pallas_dcn

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
                    pallas_attention.launches, hungarian.launches)
        k1_wgmma = pallas_dcn.wgmma_launches
        steps = rec["steps"]
        fusion_only = rec["fusion_only"]
        remat = resolve_remat(cfg) and not fusion_only
        # the matching: all L·B problems of a step in one launch
        want = (n_dcn * steps * (2 if remat else 1),
                0 if fusion_only else n_dcn * steps, 0, steps)
        moved = _moved(state, start)
        finite = all(math.isfinite(v) for r in (rec["loss_first"],
                                                rec["loss_last"])
                     for v in r.values())
        print(f"train {preset} 6x928x1600 bs1 (bf16 backbone, fp32 head, "
              f"{'fusion-only' if fusion_only else 'full backbone'}): "
              f"{steps} steps, launches K1 {launches[0]} K3 {launches[1]} "
              f"K2 {launches[2]} Hungarian {launches[3]} (want {want}: K1 "
              f"{want[0] // steps}, K3 {want[1] // steps} and one matching "
              f"per step), K1 on the wgmma tile {k1_wgmma} "
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


def ordered_abi(lib) -> bool:
    """Whether ``lib`` sums in a fixed order (``csrc/ordered_sum.cuh``):
    its K4 / K5 entries then take the partials and tickets of the channel
    sums, and its K3 and K9 entries a workspace and zeroed scratch."""
    return hasattr(lib, "msdeform_backward_value_workspace")


def parent_osa_reduce(lib, pieces, ws, s, b):
    """The K4 of ``lib`` (the parent's, or this build's for a like-for-like
    timing) with its wrapper's preparation: its Hopper tile
    ``lib.osa_reduce_bf16_wgmma`` on the K-major views ``ws`` where the
    library has one, else its wmma tile ``lib.osa_reduce_bf16`` on
    contiguous [Cᵢ, Cout] weights; with the sums' partials and tickets
    where it takes them (:func:`ordered_abi`), else a zeroed sums."""
    from transcar_tpu_torch.ops import pallas_osa

    n, h, w, _ = pieces[0].shape
    cout, k = ws[0].shape[-1], len(pieces)
    wgmma = hasattr(lib, "osa_reduce_bf16_wgmma")
    if not wgmma:
        ws = [wi.contiguous() for wi in ws]
    out = torch.empty((n, h, w, cout), dtype=pieces[0].dtype, device="cuda")
    if ordered_abi(lib):
        sums, *order = pallas_osa.sums_scratch(n, h * w, cout, "cuda")
    else:
        sums, order = torch.zeros((n, cout), dtype=torch.float32,
                                  device="cuda"), []
    ptrs = ctypes.c_void_p * k
    ints = ctypes.c_int * k
    rc = (lib.osa_reduce_bf16_wgmma if wgmma else lib.osa_reduce_bf16)(
        k, ptrs(*[p.data_ptr() for p in pieces]),
        ptrs(*[wi.data_ptr() for wi in ws]),
        ints(*[p.shape[-1] for p in pieces]),
        *([ints(*[wi.stride(1) for wi in ws])] if wgmma else []),
        *(ctypes.c_void_p(t.data_ptr()) for t in (s, b, out, sums, *order)),
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
    from transcar_tpu_torch.ops import counts, pallas_osa

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
            label = f"K4 {str(dtype)[6:]} 6x{h}x{w} sum(C)={sum(widths)}->{cout}"
            same = repeats(label, (out, sums),
                           pallas_osa.osa_reduce(pieces, ws, s, b))
            ref, ref_sums = pallas_osa.plain_osa_reduce(pieces, ws, s, b)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            _, srel = _rel_err(sums, ref_sums)
            want_tile = int(dtype == torch.bfloat16)
            ok = (math.isfinite(rel) and rel <= CONV_TOL[dtype]
                  and srel <= SUMS_TOL and took == want_tile and same)
            line = (f"K4 osa_reduce {str(dtype)[6:]} 6x{h}x{w} "
                    f"sum(C)={sum(widths)}->{cout} "
                    f"({'wgmma tile' if took else 'wmma tile'}): "
                    f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol "
                    f"{CONV_TOL[dtype]:.0e}), sums rel err {srel:.3e} (tol "
                    f"{SUMS_TOL:.0e}), launched twice: bit for bit {same}")
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
                bound, kind = bound_ms(counts.osa_reduce(n, h, w, widths,
                                                         cout),
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
                                     f" or its repeat ({same}), or took the "
                                     f"wrong tile ({took})")
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
    from transcar_tpu_torch.ops import counts, pallas_osa, pallas_osa_block

    g = torch.Generator(device="cuda").manual_seed(5)
    res = _kernel_result()
    res["parent_ms"] = 0.0 if parent is not None else None
    per_req = {"chain": 0.0, "reduce": 0.0, "cudnn_chain": 0.0}
    launch_counts = lambda: (pallas_osa_block.launches,
                             pallas_osa_block.wgmma_launches,
                             pallas_osa.launches, pallas_osa.wgmma_launches)
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
            before = launch_counts()
            out, sums = pallas_osa_block.osa_block_fused(*args,
                                                         conv_kmajor=wks)
            got = tuple(a - b for a, b in zip(launch_counts(), before))
            label = f"K5 {str(dtype)[6:]} 6x{h}x{w} {c0}->5x{ch}->{cout}"
            same = repeats(label, (out, sums), pallas_osa_block.osa_block_fused(
                *args, conv_kmajor=wks))
            ref, ref_sums = pallas_osa_block.plain_osa_block(*args)
            torch.cuda.synchronize()
            err, rel = _rel_err(out, ref)
            _, srel = _rel_err(sums, ref_sums)
            stol = SUMS_TOL if dtype == torch.float32 else CHAIN_TOL[dtype]
            bf16 = int(dtype == torch.bfloat16)
            want = (1, 5 * bf16, bf16, bf16)
            ok = (math.isfinite(rel) and rel <= CHAIN_TOL[dtype]
                  and srel <= stol and got == want and same)
            line = (f"K5 osa_block {str(dtype)[6:]} 6x{h}x{w} {c0}->5x{ch}"
                    f"->{cout}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                    f"(tol {CHAIN_TOL[dtype]:.0e}), sums rel err {srel:.3e} "
                    f"(tol {stol:.0e}); launches K5 / chain tile / K4 / K4 "
                    f"wgmma {got} (want {want}); launched twice: bit for bit "
                    f"{same}")
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
                flops = counts.osa_block(n, h, w, c0, ch, len(w9s), cout)
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
                                     f" or its repeat ({same}), or took the "
                                     f"wrong tiles ({got})")
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
    from transcar_tpu_torch.ops import counts, kernel_lib, pallas_bottleneck

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
                flops = counts.bottleneck(6, h, w, cin, cm, cout, ds)
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
    from transcar_tpu_torch.ops import (hungarian, int8, pallas_attention,
                                        pallas_bottleneck, pallas_dcn,
                                        pallas_osa, pallas_osa_block)

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
    int8.launches = int8.quantize_launches = 0
    int8.wgmma_launches = int8.amax_launches = 0
    hungarian.launches = 0


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
    want = dict.fromkeys(rec["kernel_launches"], 0)
    want["hungarian"] = rec["steps"]              # one matching a step
    if rec["kernel_launches"] != want:
        raise AssertionError(f"vovnet train launched {rec['kernel_launches']}"
                             f" (want {want})")
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
    from transcar_tpu_torch.ops import counts, kernel_lib, pallas_msdeform
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
        bound, kind = bound_ms(counts.msdeform_forward(wgt.numel(),
                                                       value.shape[3]),
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


#: what each ObjDGCNN slice runs, for its lines
LIDAR_SLICES = {
    "objdgcnn_pillar": "512x512 BEV bs1 (bf16 SECOND and FPN, fp32 head, "
                       "300 queries)",
    "objdgcnn_voxel": "0.1x0.1x0.2 m voxels on the (41, 1024, 1024) grid, "
                      "gather encoder (fp32), bf16 SECOND and FPN, fp32 "
                      "head, 300 queries, bs1",
}


def _lidar_outputs_ok(out, head) -> tuple:
    """(outputs of shape [layers, 1, Q, 10] all finite, decode finite,
    valid decoded boxes) of an ObjDGCNN request."""
    from transcar_tpu_torch.eval.decode import nms_free_decode

    shape = (head.num_decoder_layers, 1, head.num_query, 10)
    finite = all(v.shape == shape and bool(torch.isfinite(v).all())
                 for v in out.values())
    dec = nms_free_decode(out, head)
    finite_dec = (dec["boxes"].shape == (1, head.max_detections, 9)
                  and bool(torch.isfinite(dec["boxes"]).all())
                  and bool(torch.isfinite(dec["scores"]).all()))
    return finite, finite_dec, int(dec["valid"].sum())


def phase_lidar(smi: str, preset: str) -> int:
    """``objdgcnn_pillar`` or ``objdgcnn_voxel`` batch-1 inference at full
    width; the voxel preset also by layer and on its dense encoder."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.models.dgcnn import MSDeformAttention
    from transcar_tpu_torch.ops import pallas_msdeform

    cfg = get_preset(preset)
    head = cfg.model.head
    tag = preset.split("_")[1]                             # pillar | voxel
    per_req = 2 + head.num_decoder_layers                              # 8
    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "10", "--warmup", "3"])
    group = (pallas_msdeform.group_launches, pallas_msdeform.launches)
    want = {k: 0 for k in rec["kernel_launches"]}
    want["msdeform_forward"] = per_req * rec["requests"]
    finite, finite_dec, valid = _lidar_outputs_ok(out, head)
    print(f"{tag} slice {preset} {rec['max_points']} points, "
          f"{LIDAR_SLICES[preset]}: {rec['requests']} requests, launches "
          f"{rec['kernel_launches']} (want {want}); outputs "
          f"{(head.num_decoder_layers, 1, head.num_query, 10)} finite "
          f"{finite}; decode finite {finite_dec}, {valid}/"
          f"{head.max_detections} valid boxes; K7 on the lane-group kernel "
          f"{group[0]} of {group[1]}")
    print(f"{tag} audit {json.dumps(rec[f'{tag}_audit'])}")
    if rec["kernel_launches"] != want:
        raise AssertionError(f"{tag} slice launches {rec['kernel_launches']}"
                             f" != {want}")
    if group[0] != group[1]:
        raise AssertionError(f"{tag} slice: {group[1] - group[0]} K7 "
                             "launches missed the lane-group kernel")
    if not (finite and finite_dec):
        raise AssertionError(f"{tag} slice: non-finite outputs or decode")
    print(f"{tag} slice kernel path: {rec['samples_per_sec']:.3f} "
          f"samples/s ({rec['ms_per_sample']:.2f} ms/sample), peak memory "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB on {smi}")
    if tag == "voxel":
        _, model, batch, _ = benchmark._setup(benchmark.parse_args([preset]),
                                              training=False)
        print(f"voxel layers, device ms a warm request: "
              f"{voxel_layers_ms(model, batch)} on {smi}")
        del model

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
    print(f"{tag} slice fp32 (1 decoder layer) kernel path vs plain path: "
          f"max |diff|/(1+|plain|) {worst:.3e} (tol {SLICE_TOL:.0e}) "
          f"{'ok' if worst <= SLICE_TOL else 'FAIL'}")
    if not worst <= SLICE_TOL:
        raise AssertionError(f"fp32 {tag} slice: kernel path disagrees with "
                             "plain")
    del model, outs
    torch.cuda.empty_cache()
    if tag == "voxel":
        phase_voxel_dense(smi, preset, per_req)
    return rec["kernel_launches"]["msdeform_forward"]


def phase_voxel_dense(smi: str, preset: str, per_req: int) -> None:
    """The voxel request on the dense encoder (bf16 masked conv3d on the
    full grid, no cap): its outputs differ from the gather encoder's,
    whose cap binds on this cloud, so they are held finite only."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset

    _zero_counts()
    rec, out = benchmark.run([preset, "--samples", "3", "--warmup", "1",
                              "--cfg-options", "model.sparse_impl=dense"])
    finite, finite_dec, valid = _lidar_outputs_ok(
        out, get_preset(preset).model.head)
    print(f"voxel slice dense encoder (bf16 conv3d, no cap): "
          f"{rec['requests']} requests, launches "
          f"{rec['kernel_launches']['msdeform_forward']} K7; outputs "
          f"finite {finite}, decode finite {finite_dec}, {valid} valid "
          f"boxes; audit {json.dumps(rec['voxel_audit']['downsamples'])}; "
          f"{rec['samples_per_sec']:.3f} samples/s "
          f"({rec['ms_per_sample']:.2f} ms/sample), peak memory "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB on {smi}")
    if not (finite and finite_dec):
        raise AssertionError("voxel slice dense: non-finite outputs")
    if rec["kernel_launches"]["msdeform_forward"] != per_req * rec[
            "requests"]:
        raise AssertionError("voxel slice dense: K7 launches")
    del out
    torch.cuda.empty_cache()


def phase_k8_k9(parent=None) -> tuple:
    """K8 and K9 at one encoder and one decoder call of the pillar slice,
    against the plain backward, K9 launched twice (bit for bit); per call
    and per step (2 encoder + 6 decoder launches of each), beside the
    parent commit's K8 and K9 (``parent``) when given: K8 timed through
    its bare entries and also through its wrapper, the path the model
    calls; K9 through its wrapper (its workspace is the wrapper's), the
    parent's K9 through its bare entry with the zero-fill of d_value that
    its wrapper made."""
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

        before = pallas_msdeform.backward_taps_group_launches
        d_loc, d_attn = taps()
        d_value = dvalue()
        group = pallas_msdeform.backward_taps_group_launches - before
        same = repeats(f"K9 {name} Q={q}", (d_value,), (dvalue(),))
        ref_value, ref_loc, ref_attn = plain()
        torch.cuda.synchronize()
        errs = {k: _rel_err(a, b) for k, (a, b) in {
            "d_attn": (d_attn, ref_attn), "d_loc": (d_loc, ref_loc),
            "d_value": (d_value, ref_value)}.items()}
        ok = group == 1 and same and all(
            math.isfinite(rel) and rel <= MSDEFORM_BWD_TOL
            for _, rel in errs.values())
        del ref_value, ref_loc, ref_attn
        # K8's bare entries, timed as the parent's are (the wrappers' host
        # time would pass a decoder call's device time); K9 through its
        # wrapper, the parent's through its bare entry with the zero-fill
        # of d_value that its wrapper made
        tensors = (value, loc, wgt, d_out, torch.empty_like(d_loc),
                   torch.empty_like(d_attn))
        dv = torch.empty_like(d_value)
        runs = {"kernel": (msdeform_entry(
            own, group_entry(own, "msdeform_backward_taps_f32"), tensors,
            value, q), dvalue)}
        if parent is not None:
            run_value = msdeform_entry(
                parent, group_entry(parent, "msdeform_backward_value_f32"),
                (loc, wgt, d_out, dv), value, q)
            runs["parent"] = (msdeform_entry(
                parent, group_entry(parent, "msdeform_backward_taps_f32"),
                tensors, value, q), lambda: (dv.zero_(), run_value()))
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
              f"lane-group kernel {group} of 1; K9 launched twice: bit for "
              f"bit {same}; per "
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
                                 f"backward ({errs}), K9 with its repeat "
                                 f"({same}), or K8 missed the lane-group "
                                 f"kernel ({group})")
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
    print("K8 lane-group kernel / K9 kernels ptxas -v: " + " | ".join(
        dict.fromkeys(ln for ln in ptxas_lines(log) if ln.startswith(
            ("msdeform_backward_taps_group_kernel",
             "msdeform_value_sources_kernel") + ORDERED_KERNELS))))
    return res["taps"], res["value"]


def phase_lidar_train(smi: str, preset: str) -> dict:
    """``objdgcnn_pillar`` or ``objdgcnn_voxel`` training at full width
    through ``benchmark --train``."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.ops import pallas_msdeform

    tag = preset.split("_")[1]                             # pillar | voxel
    per_step = 2 + get_preset(preset).model.head.num_decoder_layers     # 8
    params0, buffers0 = _initial_state(preset)
    _zero_counts()
    rec, state = benchmark.run_train([preset, "--train", "--samples", "5",
                                      "--warmup", "2"])
    counts = (pallas_msdeform.launches,
              pallas_msdeform.backward_taps_launches,
              pallas_msdeform.backward_value_launches)
    group = (pallas_msdeform.group_launches,
             pallas_msdeform.backward_taps_group_launches)
    steps = rec["steps"]
    want = {k: 0 for k in rec["kernel_launches"]}
    for k in ("msdeform_forward", "msdeform_backward_taps",
              "msdeform_backward_value"):
        want[k] = per_step * steps
    want["hungarian"] = steps                     # one matching a step
    # elements moved: (all trainable, the voxel middle encoder's)
    moved, total = [0, 0], [0, 0]
    for name, p in state.model.named_parameters():
        n = int((p.detach() != params0[name]).sum())
        for k in (0, 1) if name.startswith("middle_encoder.") else (0,):
            moved[k], total[k] = moved[k] + n, total[k] + p.numel()
    bufs_moved = sum(int(not torch.equal(b, buffers0[n]))
                     for n, b in state.model.named_buffers())
    n_bufs = len(buffers0)
    finite = all(math.isfinite(v) for r in (rec["loss_first"],
                                            rec["loss_last"])
                 for v in r.values())
    enc = (f", of the middle encoder {moved[1]}/{total[1]}" if total[1]
           else "")
    print(f"{tag} train {preset} {rec['max_points']} points, "
          f"{LIDAR_SLICES[preset]}, dropout 0.1, batch statistics: {steps} "
          f"steps, launches {rec['kernel_launches']} (want {want}: K7, K8, "
          f"K9 {per_step} and one Hungarian matching per step), on the "
          f"lane-group kernels K7 "
          f"{group[0]} of {counts[0]}, K8 {group[1]} of {counts[1]}; loss "
          f"total first "
          f"{rec['loss_first']['total']:.4f} last "
          f"{rec['loss_last']['total']:.4f}, finite {finite}; trainable "
          f"elements moved {moved[0]}/{total[0]} "
          f"({moved[0] / total[0]:.4f}){enc}; BN running statistics moved "
          f"{bufs_moved}/{n_bufs}; peak memory "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"{rec['ms_per_step']:.2f} ms/step, {rec['steps_per_sec']:.3f} "
          f"steps/s on {smi}")
    if rec["kernel_launches"] != want or counts != (per_step * steps,) * 3:
        raise AssertionError(f"{tag} train launches {rec['kernel_launches']}"
                             f" / {counts} != {want}")
    if group != counts[:2]:
        raise AssertionError(f"{tag} train: K7 / K8 launches {counts[:2]}, "
                             f"on the lane-group kernels {group}")
    if not finite:
        raise AssertionError(f"{tag} train: non-finite loss")
    if (any(m <= 0.9 * t for m, t in zip(moved, total) if t)
            or bufs_moved != n_bufs):
        raise AssertionError(f"{tag} train: moved {moved}/{total} elements "
                             f"(all, middle encoder), {bufs_moved}/{n_bufs} "
                             "BN statistics")
    launches = rec["kernel_launches"]
    del state, params0, buffers0
    torch.cuda.empty_cache()
    return launches


#: a leaf whose gradient is zero but for rounding → the leaf whose
#: gradient's scale it is held at: the voxel encoder's ``out_conv`` bias
#: meets ``out_bn``'s batch mean, which takes it out again
ZERO_GRAD_LEAVES = {
    "middle_encoder.out_conv.bias": "middle_encoder.out_conv.weight"}


def phase_lidar_train_check(preset: str) -> None:
    """One float32 step of ``objdgcnn_pillar`` or ``objdgcnn_voxel``
    (float32 BEV, one decoder layer, dropout 0, batch statistics) at the
    preset's own width and BEV levels, the kernel path (K7, K8, K9)
    against the plain path (``impl = "xla"`` on every MSDeformAttention),
    from the same weights and batch, in the process's deterministic mode
    (cuDNN's too), so that the BEV backward is the same on both.  The
    voxel encoder's backward is gathers (``ops/sparse.GatherConv``), the
    same on both and in one order."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.models.dgcnn import MSDeformAttention
    from transcar_tpu_torch.ops import pallas_msdeform
    from transcar_tpu_torch.train.step import compute_losses, init_state

    tag = preset.split("_")[1]                             # pillar | voxel
    args = benchmark.parse_args([
        preset, "--train", "--dropout", "0", "--cfg-options",
        "model.lidar_compute_dtype=float32",
        "model.head.num_decoder_layers=1"])
    runs = []
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
    (lk, gk, bk, ck), (lp, gp, bp, cp) = runs
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    worst_name, worst, held = "", 0.0, {}
    for name, ref in gp.items():
        scale = gp[ZERO_GRAD_LEAVES.get(name, name)].abs().max()
        err = ((gk[name] - ref).abs().max() / scale.clamp(min=1e-30)).item()
        if name in ZERO_GRAD_LEAVES:
            held[name] = (f"{err:.3e} at the scale of "
                          f"{ZERO_GRAD_LEAVES[name]} (max|plain| "
                          f"{ref.abs().max().item():.3e} against "
                          f"{scale.item():.3e})")
        if not err <= worst:
            worst_name, worst = name, err
    stats = max(((bk[n] - b).abs().max() / b.abs().max().clamp(min=1e-30))
                .item() for n, b in bp.items())
    ok = (gk.keys() == gp.keys() and loss_err <= STEP_TOL
          and worst <= PILLAR_GRAD_TOL and ck == (3, 3, 3) and cp == (0,) * 3)
    print(f"{tag} train check fp32 (1 decoder layer, dropout 0), kernel vs "
          f"plain, one step: launches kernel {ck} plain {cp}; loss rel err "
          f"{loss_err:.3e} (tol {STEP_TOL:.0e}); gradients of {len(gp)} "
          f"leaves, worst max|diff|/max|plain| {worst:.3e} at {worst_name} "
          f"(tol {PILLAR_GRAD_TOL:.0e}"
          + "".join(f"; {n} {e}" for n, e in held.items())
          + f"); BN running statistics rel diff {stats:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} train check: kernel path disagrees "
                             "with the plain path")


def voxel_layers_ms(model, batch) -> dict:
    """Device ms of each layer of a warm ``objdgcnn_voxel`` request
    (CUDA events, each layer on the previous one's output): voxelize +
    VFE, the middle encoder and, of it, the site sets alone (lookup
    tables, rule books, downsampled sets), SECOND + FPN, the head."""
    from transcar_tpu_torch.ops import sparse

    enc = model.middle_encoder
    cloud = (batch["points"], batch["num_points"])
    with torch.inference_mode():
        inputs = model.voxel_features(*cloud)
        bev = enc(*inputs)
        x = bev.to(getattr(torch, model.compute_dtype)).permute(0, 3, 1, 2)
        levels = [f.permute(0, 2, 3, 1).float()
                  for f in model.neck(model.backbone(x))]

        def sites():
            s = sparse.Sites(inputs[1], inputs[2], enc.sparse_shape)
            for _ in range(3):
                s.subm_rules
                out = sparse.down_sites(s, inputs[0].shape[1])
                sparse.down_rules(s, out)
                s = out
            return s.subm_rules

        ms = {"voxelize_vfe": cuda_ms(lambda: model.voxel_features(*cloud),
                                      10),
              "middle_encoder": cuda_ms(lambda: enc(*inputs), 10),
              "site_sets": cuda_ms(sites, 10),
              "second_fpn": cuda_ms(lambda: model.neck(model.backbone(x)),
                                    10),
              "head": cuda_ms(lambda: model.head(levels), 10)}
    return {k: round(v, 3) for k, v in ms.items()}


# ---------------------------------------------------------------------------
# the data pipeline phase: a nuScenes-layout fixture on disk, then the
# train / test CLIs on it
# ---------------------------------------------------------------------------

#: cameras in the order of data/infos.py (the ring of data/synthetic.py:
#: camera i faces azimuth 2πi/6)
FIXTURE_CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
#: radar channel → (mounting x, y, z in the ego frame, yaw)
FIXTURE_RADARS = {"RADAR_FRONT": (3.4, 0.0, 0.5, 0.0),
                  "RADAR_FRONT_LEFT": (2.4, 0.8, 0.5, math.pi / 2),
                  "RADAR_FRONT_RIGHT": (2.4, -0.8, 0.5, -math.pi / 2),
                  "RADAR_BACK_LEFT": (-0.6, 0.8, 0.5, math.pi * 0.75),
                  "RADAR_BACK_RIGHT": (-0.6, -0.8, 0.5, -math.pi * 0.75)}
FIXTURE_T0 = 1_531_883_530_000_000          # µs, nuScenes' magnitude


def _yaw_quat(yaw: float) -> list:
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def _fixture_image(rng, h: int, w: int):
    """A smooth seeded RGB picture (small as a JPEG): a coarse random
    grid upsampled bicubically."""
    import numpy as np
    from PIL import Image

    coarse = rng.integers(0, 256, (max(h // 60, 2), max(w // 60, 2), 3),
                          dtype=np.uint8)
    return Image.fromarray(coarse).resize((w, h), Image.BICUBIC)


def _fixture_radar_sweep(rng, n: int):
    """[18, n] radar points in the sensor frame that pass the devkit's
    default filters: 5-80 m ahead within ±45°, every column in its
    on-disk dtype's range."""
    import numpy as np

    pts = np.zeros((18, n), np.float64)
    r = rng.uniform(5.0, 80.0, n)
    az = rng.uniform(-math.pi / 4, math.pi / 4, n)
    pts[0] = (r * np.cos(az)).astype(np.float32)
    pts[1] = (r * np.sin(az)).astype(np.float32)
    pts[2] = rng.uniform(-0.5, 1.5, n).astype(np.float32)
    pts[3] = rng.integers(0, 7, n)                            # dyn_prop
    pts[4] = rng.integers(0, 100, n)                          # id
    pts[5] = rng.uniform(-10, 30, n).astype(np.float32)       # rcs
    pts[6:10] = rng.uniform(-15, 15, (4, n)).astype(np.float32)
    pts[10] = 1                                               # quality
    pts[11] = 3                                               # ambig
    pts[12:14] = rng.integers(0, 5, (2, n))
    pts[14] = 0                                               # invalid
    pts[15] = rng.integers(0, 8, n)                           # pdh0
    pts[16:18] = rng.integers(0, 5, (2, n))
    return pts


def write_fixture(root: str, n_train: int = 4, n_val: int = 2,
                  hw=(900, 1600), lidar_points: int = 300_000,
                  radar_points: int = 60, radar_sweeps: int = 5,
                  lidar_sweeps: int = 9, seed: int = 0) -> dict:
    """Write a nuScenes-layout dataset under ``root``: the infos pkls
    (``nuscenes_infos_{train,val}.pkl``), six ``hw`` camera JPEGs a
    sample, LiDAR ``.bin`` files (a key frame and ``lidar_sweeps``
    sweeps, ``lidar_points`` points in all), and the nuScenes tables of
    ``v1.0-trainval`` with ``radar_sweeps`` ``.pcd`` sweeps of
    ``radar_points`` points for each of the 5 radars.  Three boxes a
    sample (car, bus, pedestrian), as the JAX package's loop tests make.
    Returns the train and val sample tokens."""
    import pickle

    import numpy as np

    from transcar_tpu_torch.data.radar_io import write_radar_pcd

    rng = np.random.default_rng(seed)
    h, w = hw
    root = str(root)
    version = os.path.join(root, "v1.0-trainval")
    for sub in ("samples", "sweeps", "v1.0-trainval"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    fx = 0.8 * w
    k = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    tables = {t: [] for t in ("sample", "sample_data", "ego_pose",
                              "calibrated_sensor", "sensor")}
    for chan, (x, y, z, yaw) in (("LIDAR_TOP", (0.9, 0.0, 1.8, 0.0)),
                                 *FIXTURE_RADARS.items()):
        tables["sensor"].append({"token": f"sen_{chan}", "channel": chan,
                                 "modality": chan.split("_")[0].lower()})
        tables["calibrated_sensor"].append({
            "token": f"cs_{chan}", "sensor_token": f"sen_{chan}",
            "translation": [x, y, z], "rotation": _yaw_quat(yaw)})
    per_file = lidar_points // (lidar_sweeps + 1)
    infos = []
    for i in range(n_train + n_val):
        tok = f"sample{i}"
        ts = FIXTURE_T0 + i * 500_000
        cams = {}
        for ci, cam in enumerate(FIXTURE_CAMS):
            path = os.path.join(root, "samples", f"{tok}_{cam}.jpg")
            _fixture_image(rng, h, w).save(path, quality=90)
            a = 2 * np.pi * ci / 6
            fwd = np.array([np.cos(a), np.sin(a), 0.0])
            right = np.array([-np.sin(a), np.cos(a), 0.0])
            rot = np.stack([right, [0.0, 0.0, -1.0], fwd])  # lidar → cam
            cams[cam] = {"data_path": path, "sensor2lidar_rotation": rot.T,
                         "sensor2lidar_translation": np.zeros(3),
                         "cam_intrinsic": k}

        def cloud(n):
            r = 2.0 + 68.0 * rng.random(n) ** 1.5
            az = rng.uniform(-np.pi, np.pi, n)
            pts = np.stack([r * np.cos(az), r * np.sin(az),
                            rng.uniform(-2.5, 1.5, n),
                            rng.uniform(0, 255, n),
                            rng.integers(0, 32, n)], 1)
            return pts.astype(np.float32)

        lidar_path = os.path.join(root, "samples", f"{tok}_LIDAR_TOP.bin")
        cloud(per_file).tofile(lidar_path)
        sweeps = []
        for s in range(lidar_sweeps):
            path = os.path.join(root, "sweeps", f"{tok}_LIDAR_TOP_{s}.bin")
            cloud(per_file).tofile(path)
            a = 0.01 * (s + 1)
            sweeps.append({
                "data_path": path,
                "sensor2lidar_rotation": np.array(
                    [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]),
                "sensor2lidar_translation": np.array(
                    [-0.5 * (s + 1), 0.0, 0.0]),
                "timestamp": ts - (s + 1) * 50_000})
        g = 3
        boxes = np.zeros((g, 7))
        boxes[:, :2] = rng.uniform(-30, 30, (g, 2))
        boxes[:, 2] = rng.uniform(-1, 1, g)
        boxes[:, 3:6] = rng.uniform(1, 4, (g, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, g)
        infos.append({
            "token": tok, "timestamp": ts, "lidar_path": lidar_path,
            "sweeps": sweeps, "cams": cams,
            "lidar2ego_rotation": [1, 0, 0, 0],
            "lidar2ego_translation": [0.9, 0.0, 1.8],
            "ego2global_rotation": [1, 0, 0, 0],
            "ego2global_translation": [10.0 * i, 0.0, 0.0],
            "gt_boxes": boxes, "gt_names": ["car", "bus", "pedestrian"],
            "gt_velocity": rng.uniform(-2, 2, (g, 2)),
            "num_lidar_pts": np.array([50, 50, 50]),
            "num_radar_pts": np.array([3, 3, 3]),
            "valid_flag": np.array([True, True, True])})

        # the nuScenes tables: the key frame's LIDAR_TOP and every
        # radar's chain of sweeps (newest first, linked by "prev")
        tables["sample"].append({"token": tok, "timestamp": ts,
                                 "scene_token": "scene0", "prev": "",
                                 "next": ""})
        chans = [("LIDAR_TOP", 1)] + [(c, radar_sweeps)
                                      for c in FIXTURE_RADARS]
        for ci, (chan, n_chain) in enumerate(chans):
            toks = [f"{tok}_{chan}_{s}" for s in range(n_chain)]
            for s, sd_tok in enumerate(toks):
                sd_ts = ts - s * 75_000 + ci * 5_000
                tables["ego_pose"].append({
                    "token": f"pose_{sd_tok}", "timestamp": sd_ts,
                    "translation": [10.0 * i + 8.0 * (sd_ts - ts) / 1e6,
                                    0.0, 0.0],
                    "rotation": _yaw_quat(0.02 * (sd_ts - ts) / 1e6)})
                fname = f"sweeps/{sd_tok}.pcd"
                tables["sample_data"].append({
                    "token": sd_tok, "sample_token": tok,
                    "ego_pose_token": f"pose_{sd_tok}",
                    "calibrated_sensor_token": f"cs_{chan}",
                    "filename": fname, "timestamp": sd_ts,
                    "is_key_frame": s == 0,
                    "prev": toks[s + 1] if s + 1 < n_chain else "",
                    "next": toks[s - 1] if s > 0 else ""})
                if chan != "LIDAR_TOP":
                    write_radar_pcd(os.path.join(root, fname),
                                    _fixture_radar_sweep(rng, radar_points))
    for name, rows in tables.items():
        with open(os.path.join(version, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    for name, part in (("nuscenes_infos_train.pkl", infos[:n_train]),
                       ("nuscenes_infos_val.pkl", infos[n_train:])):
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({"infos": part, "metadata": {"version": "fixture"}},
                        f)
    return {"train": [i["token"] for i in infos[:n_train]],
            "val": [i["token"] for i in infos[n_train:]]}


def write_reference_pth(path: str, blocks=(3, 4, 23, 3),
                        with_dcn=(False, False, True, True),
                        num_layers: int = 6, num_query: int = 900,
                        seed: int = 0) -> int:
    """A camera-only DETR3D checkpoint in the reference's key layout
    (mmdet ResNet / FPN, ``pts_bbox_head``; the keys and shapes of
    ``tests/test_convert.py``'s synthetic state_dict without its
    ``rf_*`` / ``radar_*`` / ``final_*`` heads), saved with
    ``torch.save`` as ``{"state_dict": ...}``.  Its values are scaled so
    that a forward stays finite: convs and linears N(0, 1/fan_in), BN
    statistics with positive variances, offset convs that move taps by
    about a pixel.  Returns the number of tensors."""
    import numpy as np

    rng = np.random.default_rng(seed)
    e = 256
    sd = {}

    def add(k, arr):
        sd[k] = torch.from_numpy(np.asarray(arr, np.float32))

    def add_bn(k, c, gain=1.0):
        add(f"{k}.weight", gain * rng.uniform(0.5, 1.0, c))
        add(f"{k}.bias", rng.normal(0, 0.1, c))
        add(f"{k}.running_mean", rng.normal(0, 0.1, c))
        add(f"{k}.running_var", rng.uniform(0.5, 1.5, c))

    def add_conv(k, o, i, kh, kw, bias=False, std=None):
        std = std if std is not None else (i * kh * kw) ** -0.5
        add(f"{k}.weight", rng.normal(0, std, (o, i, kh, kw)))
        if bias:
            add(f"{k}.bias", rng.normal(0, 0.1, o))

    def add_lin(k, o, i):
        add(f"{k}.weight", rng.normal(0, i ** -0.5, (o, i)))
        add(f"{k}.bias", rng.normal(0, 0.02, o))

    def add_ln(k, c):
        add(f"{k}.weight", 1.0 + rng.normal(0, 0.1, c))
        add(f"{k}.bias", rng.normal(0, 0.1, c))

    p = "img_backbone"
    add_conv(f"{p}.conv1", 64, 3, 7, 7)
    add_bn(f"{p}.bn1", 64)
    planes, inc = 64, 64
    for s, nb in enumerate(blocks):
        for b in range(nb):
            tp = f"{p}.layer{s + 1}.{b}"
            add_conv(f"{tp}.conv1", planes, inc if b == 0 else planes * 4,
                     1, 1)
            add_bn(f"{tp}.bn1", planes)
            add_conv(f"{tp}.conv2", planes, planes, 3, 3)
            if with_dcn[s]:
                add_conv(f"{tp}.conv2.conv_offset", 27, planes, 3, 3,
                         bias=True, std=0.5 / (9 * planes) ** 0.5)
            add_bn(f"{tp}.bn2", planes)
            add_conv(f"{tp}.conv3", planes * 4, planes, 1, 1)
            add_bn(f"{tp}.bn3", planes * 4, gain=0.3)
            if b == 0:
                add_conv(f"{tp}.downsample.0", planes * 4,
                         inc if s == 0 else planes * 2, 1, 1)
                add_bn(f"{tp}.downsample.1", planes * 4)
        inc = planes * 4
        planes *= 2
    for i, c in enumerate((512, 1024, 2048)):
        add_conv(f"img_neck.lateral_convs.{i}.conv", 256, c, 1, 1,
                 bias=True)
    for i in range(4):
        add_conv(f"img_neck.fpn_convs.{i}.conv", 256, 256, 3, 3, bias=True)
    h = "pts_bbox_head"
    add(f"{h}.query_embedding.weight", rng.normal(0, 1, (num_query, 2 * e)))
    add_lin(f"{h}.transformer.reference_points", 3, e)
    for layer in range(num_layers):
        dl = f"{h}.transformer.decoder.layers.{layer}"
        add(f"{dl}.attentions.0.attn.in_proj_weight",
            rng.normal(0, e ** -0.5, (3 * e, e)))
        add(f"{dl}.attentions.0.attn.in_proj_bias", np.zeros(3 * e))
        add_lin(f"{dl}.attentions.0.attn.out_proj", e, e)
        add_lin(f"{dl}.attentions.1.attention_weights", 24, e)
        add_lin(f"{dl}.attentions.1.output_proj", e, e)
        add_lin(f"{dl}.attentions.1.position_encoder.0", e, 3)
        add_ln(f"{dl}.attentions.1.position_encoder.1", e)
        add_lin(f"{dl}.attentions.1.position_encoder.3", e, e)
        add_ln(f"{dl}.attentions.1.position_encoder.4", e)
        add_lin(f"{dl}.ffns.0.layers.0.0", 512, e)
        add_lin(f"{dl}.ffns.0.layers.1", e, 512)
        for ni in range(3):
            add_ln(f"{dl}.norms.{ni}", e)
        cb = f"{h}.cls_branches.{layer}"
        add_lin(f"{cb}.0", e, e)
        add_ln(f"{cb}.1", e)
        add_lin(f"{cb}.3", e, e)
        add_ln(f"{cb}.4", e)
        add_lin(f"{cb}.6", 10, e)
        rb = f"{h}.reg_branches.{layer}"
        add_lin(f"{rb}.0", e, e)
        add_lin(f"{rb}.2", e, e)
        add_lin(f"{rb}.4", 10, e)
    torch.save({"state_dict": sd, "meta": {"fixture": True}}, path)
    return len(sd)


#: card against CPU for the photometric normalize, on the 0-255 scale
#: (tests/test_device_normalize.py:93)
PHOTOMETRIC_TOL = 2e-2
#: ``cli.test`` against the eval hook, the same checkpoint
HOOK_TOL = 1e-5


class _Tee:
    """stdout copied into a string as it is printed."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _run_cli(main, argv) -> tuple:
    """``main(argv)`` with its printed lines captured; (result, text)."""
    import contextlib
    import sys

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = main(argv)
    return result, tee.text()


def _train_records(work_dir: str) -> list:
    """Every json-log record of ``work_dir``, oldest log first."""
    recs = []
    for path in sorted(pathlib.Path(work_dir).glob("*.log.json")):
        recs += [json.loads(line) for line in path.read_text().splitlines()]
    return recs


def _step_stats(recs: list) -> dict:
    """Of the train records (one a step): steps, ms a step after the
    first, loader wait (s), peak memory (GiB), every loss finite."""
    train = [r for r in recs if r.get("mode") == "train" and "total" in r]
    later = [r["time"] for r in train[1:]]
    return {"steps": len(train), "ms_each": [round(1e3 * r["time"], 1)
                                             for r in train],
            "wait_ms_each": [round(1e3 * r["data_time"], 1) for r in train],
            "ms_per_step": 1e3 * sum(later) / max(len(later), 1),
            "loader_wait_s": sum(r["data_time"] for r in train),
            "peak_gib": max(r.get("memory", 0) for r in train) / 1024,
            "finite": all(math.isfinite(v) for r in train
                          for k, v in r.items()
                          if k.startswith("loss") or k == "total"),
            "first_step": train[0]["step"] if train else None}


def _probe_routes() -> tuple:
    """The decode and featurizer routes this host should take: native
    decode where libjpeg's header compiles (else PIL, if installed, else
    none), the native featurizer where g++ and make are on the path."""
    import importlib.util
    import shutil

    headers = subprocess.run(
        ["g++", "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
        capture_output=True, text=True).returncode == 0 \
        if shutil.which("g++") else False
    pil = importlib.util.find_spec("PIL") is not None
    decode = "native" if headers and pil else ("pil" if pil else None)
    featurize = ("native" if shutil.which("g++") and shutil.which("make")
                 else "numpy")
    return decode, featurize, {"jpeglib.h": headers, "PIL": pil}


def _loader_ms(cfg, nusc, dataset) -> dict:
    """Host ms a sample of the camera loader on the fixture's train
    samples (one thread, outside the loop, after one untimed sample):
    decode, radar tokens, the rest of ``prepare_sample``; its wire bytes,
    uint8 against the float32 wire; and the seconds the first use took to
    build (or fail to build) the two native libraries."""
    import numpy as np

    from transcar_tpu_torch import native
    from transcar_tpu_torch.data import pipeline
    from transcar_tpu_torch.data.loader import prepare_sample
    from transcar_tpu_torch.data.radar import load_radar_tokens

    t0 = time.perf_counter()
    built = {}
    for name in native.SOURCES:
        try:
            native.build(name)
            built[name] = True
        except RuntimeError:
            built[name] = False
    build_s = time.perf_counter() - t0
    dec, rad, rest = [], [], []
    for i in [0] + list(range(len(dataset))):
        s = dataset.get_sample(i)
        t0 = time.perf_counter()
        pipeline.load_multiview_stack_u8(s.img_paths, cfg.data.pad_divisor)
        t1 = time.perf_counter()
        tokens = load_radar_tokens(nusc, s.token,
                                   nsweeps=cfg.data.radar_sweeps,
                                   num_tokens=cfg.model.head.num_radar_tokens)
        t2 = time.perf_counter()
        out = prepare_sample(s, cfg.data, True, np.random.default_rng(i),
                             lambda token: tokens)
        t3 = time.perf_counter()
        dec.append(t1 - t0)
        rad.append(t2 - t1)
        rest.append(t3 - t2 - (t1 - t0))
    dec, rad, rest = dec[1:], rad[1:], rest[1:]           # warm
    wire = sum(v.nbytes for v in out.values())
    n = len(dec)
    return {"decode_ms": 1e3 * sum(dec) / n, "radar_ms": 1e3 * sum(rad) / n,
            "rest_ms": 1e3 * sum(rest) / n, "wire_u8_mb": wire / 1e6,
            "wire_f32_mb": (wire + 3 * out["images"].nbytes) / 1e6,
            "native_build_s": build_s, "native_built": built}


def _normalize_check(cfg, dataset, tokens_fn) -> tuple:
    """One fixture train batch through ``normalize_batch_images`` on the
    card and on the CPU: (bit-equal without photometric, max |diff| with
    it on the 0-255 scale)."""
    import numpy as np

    from transcar_tpu_torch.data.loader import collate, prepare_sample
    from transcar_tpu_torch.train.step import normalize_batch_images

    batch = collate([prepare_sample(dataset.get_sample(0), cfg.data, True,
                                    np.random.default_rng(7), tokens_fn)])
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain = {k: v for k, v in tensors.items() if not k.startswith("photo")}
    outs = []
    for b in (plain, tensors):
        cpu = normalize_batch_images(b, cfg.data)["images"]
        gpu = normalize_batch_images({k: v.cuda() for k, v in b.items()},
                                     cfg.data)["images"].cpu()
        outs.append((cpu, gpu))
    (c0, g0), (c1, g1) = outs
    if torch.equal(c0, c1):       # else the photometric check is idle
        raise AssertionError("pipeline: no photometric draw in the batch")
    return torch.equal(c0, g0), (c1 - g1).abs().max().item()


def phase_pipeline(smi: str, then=None) -> None:
    """The data pipeline, checkpoints, train loop, eval hook and the
    train / test CLIs at full width on a nuScenes-layout fixture
    (:func:`write_fixture`: 4 train and 2 val samples, six 900 × 1600
    JPEGs, 5 radars × 5 sweeps, LiDAR key frame + 9 sweeps of 300 000
    points; :func:`write_reference_pth` at full R101 depth).  ``then(tmp,
    data)``, if given, runs before the fixture and the runs' work dirs
    under ``tmp`` are removed (``data``: the ``--cfg-options`` that point
    at the fixture)."""
    import shutil
    import tempfile

    from transcar_tpu_torch.cli import train as cli_train
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.data import pipeline, radar
    from transcar_tpu_torch.data.infos import NuScenesInfos
    from transcar_tpu_torch.data.radar_io import NuScenesTables
    from transcar_tpu_torch.models.resnet import RESNET_DEPTHS

    t_phase = time.perf_counter()
    want_decode, want_featurize, probe = _probe_routes()
    tmp = tempfile.mkdtemp(prefix="transcar_pipeline_")
    try:
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        tokens = write_fixture(root)
        ref = os.path.join(tmp, "detr3d_ref.pth")
        n_ref = write_reference_pth(ref)
        print(f"pipeline fixture: {len(tokens['train'])} train + "
              f"{len(tokens['val'])} val samples, 6 x 900x1600 JPEGs, 5 "
              f"radars x 5 sweeps, LiDAR key frame + 9 sweeps of 300000 "
              f"points, reference .pth of {n_ref} tensors, in "
              f"{time.perf_counter() - t0:.1f} s; host probe {probe}: want "
              f"decode route {want_decode}, featurizer {want_featurize}")
        data = [f"data.data_root={root}"]
        camera = want_decode is not None
        cams = get_preset("transcar_r101", {"data.data_root": root})
        if camera:
            train_ds = NuScenesInfos(
                os.path.join(root, cams.data.ann_train), data_root=root)
            nusc = NuScenesTables(root, version=cams.data.version)
            radar_fn = cli_train._try_radar_fn(cams)
            host = _loader_ms(cams, nusc, train_ds)
            same, photo_err = _normalize_check(cams, train_ds, radar_fn)
            print(f"pipeline native libraries {host['native_built']} "
                  f"(built or refused in {host['native_build_s']:.2f} s); "
                  f"loader (one thread, warm, host of {smi}): "
                  f"{host['decode_ms']:.1f} ms decode + "
                  f"{host['radar_ms']:.1f} ms radar tokens + "
                  f"{host['rest_ms']:.1f} ms rest a sample; wire "
                  f"{host['wire_u8_mb']:.2f} MB a sample uint8 against "
                  f"{host['wire_f32_mb']:.2f} MB float32; normalize on the "
                  f"card against the CPU: bit-equal without photometric "
                  f"{same}, photometric max |diff| {photo_err:.3g} (tol "
                  f"{PHOTOMETRIC_TOL})")
            if not same or not photo_err <= PHOTOMETRIC_TOL:
                raise AssertionError("pipeline: normalize_batch_images on "
                                     "the card disagrees with the CPU")
            n_dcn = sum(d for d, dcn in zip(RESNET_DEPTHS[101],
                                           cams.model.backbone.with_dcn)
                        if dcn)                                       # 26
            _pipeline_camera_runs(tmp, data, ref, n_dcn, smi)
            routes = (dict(pipeline.decode_routes),
                      dict(radar.featurize_routes))
            print(f"pipeline routes: decode {routes[0]} (last fallback: "
                  f"{pipeline.last_fallback}), featurizer {routes[1]}")
            if (set(k for k, v in routes[0].items() if v) != {want_decode}
                    or set(k for k, v in routes[1].items() if v)
                    != {want_featurize}):
                raise AssertionError(f"pipeline: routes {routes}, want "
                                     f"{want_decode} / {want_featurize}")
        else:
            print("pipeline camera runs: not run, this host has neither "
                  "Pillow nor libjpeg's headers, so no route reads a JPEG")
        _pipeline_lidar_run(tmp, data, smi)
        print(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s on "
              f"{smi}")
        if then is not None:
            then(tmp, data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _pipeline_counts() -> dict:
    from transcar_tpu_torch.ops import (pallas_attention, pallas_dcn,
                                        pallas_msdeform)

    return {"K1": pallas_dcn.launches, "K1 wgmma": pallas_dcn.wgmma_launches,
            "K3": pallas_dcn.backward_launches,
            "K2": pallas_attention.launches,
            "K2 wgmma": pallas_attention.mma_launches,
            "K7": pallas_msdeform.launches,
            "K7 group": pallas_msdeform.group_launches,
            "K8": pallas_msdeform.backward_taps_launches,
            "K8 group": pallas_msdeform.backward_taps_group_launches,
            "K9": pallas_msdeform.backward_value_launches}


def _want(name: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    print(f"pipeline {name}: launches {got} (want {want})")
    if bad:
        raise AssertionError(f"pipeline {name}: launches (got, want) {bad}")


def _pipeline_camera_runs(tmp: str, data: list, ref: str, n_dcn: int,
                          smi: str) -> None:
    """Runs 1-4 of the pipeline phase: ``detr3d_r101`` training, the
    ``transcar_r101`` warm start with its eval hook and trace, its
    resume, and ``cli.test`` on the hook's checkpoint."""
    import numpy as np

    from transcar_tpu_torch.cli import test as cli_test
    from transcar_tpu_torch.cli import train as cli_train
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.models.detector import resolve_remat

    # 1. detr3d_r101: full-backbone steps, photometric on the uint8 wire
    w1 = os.path.join(tmp, "w_detr3d")
    _zero_counts()
    cli_train.main(["detr3d_r101", "--work-dir", w1, "--max-steps", "2",
                    "--no-validate", "--log-interval", "1",
                    "--cfg-options", *data])
    got = _pipeline_counts()
    st = _step_stats(_train_records(w1))
    remat = resolve_remat(get_preset("detr3d_r101"))
    k1 = n_dcn * (2 if remat else 1) * st["steps"]
    _want("detr3d_r101 train (2 steps)", got,
          {"K1": k1, "K1 wgmma": k1, "K3": n_dcn * st["steps"], "K2": 0})
    print(f"pipeline detr3d_r101 train: {st['ms_per_step']:.1f} ms a step "
          f"after the first (each {st['ms_each']} ms, of it loader wait "
          f"{st['wait_ms_each']} ms), loader wait {st['loader_wait_s']:.3f} s over "
          f"{st['steps']} steps, peak {st['peak_gib']:.2f} GiB, losses "
          f"finite {st['finite']} on {smi}")
    if not st["finite"] or st["steps"] != 2:
        raise AssertionError(f"pipeline detr3d_r101: {st}")

    # 2. transcar_r101 from the camera-only reference .pth, eval hook on
    w2 = os.path.join(tmp, "w_transcar")
    trace = os.path.join(tmp, "trace")
    _zero_counts()
    state, text = _run_cli(cli_train.main, [
        "transcar_r101", "--work-dir", w2, "--load-from", ref,
        "--max-steps", "6", "--eval-samples", "2", "--log-interval", "1",
        "--trace-dir", trace, "--trace-start", "1", "--trace-steps", "2",
        "--cfg-options", *data])
    got = _pipeline_counts()
    recs = _train_records(w2)
    st = _step_stats(recs)
    hook = state.last_eval
    n_eval = len(hook.detections["tokens"])
    _want(f"transcar_r101 train ({st['steps']} steps) + eval hook "
          f"({n_eval} samples)", got,
          {"K1": n_dcn * (st["steps"] + n_eval),
           "K1 wgmma": n_dcn * (st["steps"] + n_eval), "K3": 0,
           "K2": 3 * n_eval, "K2 wgmma": 3 * n_eval})
    merge = [line for line in text.splitlines()
             if line.startswith("[load_from]")]
    summary = json.loads(pathlib.Path(trace, "summary.json").read_text())
    val = [r for r in recs if r.get("mode") == "val"]
    metrics = {k: v for k, v in val[-1].items()
               if k in ("mAP", "NDS", "mATE", "mASE", "mAOE", "mAVE",
                        "mAAE")} if val else {}
    untraced = [ms for k, ms in enumerate(st["ms_each"])
                if k not in (0, 1, 2)]         # the first, and the window
    busy = summary["device_busy_ms_per_iter"]
    print(f"pipeline transcar_r101 train: load_from {merge}; "
          f"{st['ms_per_step']:.1f} ms a step after the first (each "
          f"{st['ms_each']} ms, of it loader wait {st['wait_ms_each']} ms; "
          f"steps 2-3 traced), loader "
          f"wait {st['loader_wait_s']:.3f} s over {st['steps']} steps, "
          f"peak {st['peak_gib']:.2f} GiB, losses finite {st['finite']}; "
          f"traced window {summary['iterations']} steps: "
          f"{summary['wall_ms_per_iter']:.1f} ms wall, "
          f"{busy:.1f} ms device busy a step, idle share "
          f"{summary['device_idle_share']} of the profiled wall, "
          f"{1 - busy / (sum(untraced) / max(len(untraced), 1)):.3f} of the "
          f"untraced steps' mean; val "
          f"json {os.path.basename(hook.path)} with "
          f"{sum(len(v) for v in json.load(open(hook.path))['results'].values())} "
          f"annos, native metrics {metrics} ({val[-1].get('metrics_source') if val else None}) on {smi}")
    if (not st["finite"] or st["steps"] != 6 or len(merge) != 2
            or not metrics or not all(math.isfinite(v)
                                      for v in metrics.values())
            or (torch.cuda.is_available()
                and summary["device_idle_share"] is None)):
        raise AssertionError(f"pipeline transcar_r101: {st}, merge {merge}"
                             f", metrics {metrics}, trace {summary}")

    # 3. resume the same work dir to step 7
    _zero_counts()
    cli_train.main(["transcar_r101", "--work-dir", w2, "--resume-from", w2,
                    "--max-steps", "7", "--no-validate", "--log-interval",
                    "1", "--cfg-options", *data])
    resumed = _step_stats(_train_records(w2)[len(recs):])
    ckpts = sorted(int(p.name) for p in
                   pathlib.Path(w2, "checkpoints").iterdir())
    print(f"pipeline resume: first step {resumed['first_step']} of "
          f"{resumed['steps']}, losses finite {resumed['finite']}; "
          f"checkpoints {ckpts} (keeps at most 5)")
    if (resumed["first_step"] != 7 or resumed["steps"] != 1
            or ckpts != [4, 6, 7] or not resumed["finite"]):
        raise AssertionError(f"pipeline resume: {resumed}, ckpts {ckpts}")

    # 4. cli.test on the checkpoint the hook evaluated: the hook's rows
    _zero_counts()
    res = cli_test.main(["transcar_r101", os.path.join(w2, "checkpoints",
                                                        "6"),
                         "--out", os.path.join(tmp, "test.json"),
                         "--cfg-options", *data])
    got = _pipeline_counts()
    n = len(res.detections["tokens"])
    _want(f"transcar_r101 cli.test ({n} samples)", got,
          {"K1": n_dcn * n, "K1 wgmma": n_dcn * n, "K3": 0, "K2": 3 * n,
           "K2 wgmma": 3 * n})
    a, b = res.detections, hook.detections
    box_err = float(np.abs(a["boxes"] - b["boxes"]).max())
    same_labels = bool((a["labels"] == b["labels"]).all())
    print(f"pipeline cli.test = eval hook (checkpoint 6): boxes max |diff| "
          f"{box_err:.3g} (tol {HOOK_TOL}), labels equal {same_labels}, "
          f"tokens {list(a['tokens'])}")
    if (list(a["tokens"]) != list(b["tokens"]) or not box_err <= HOOK_TOL
            or not same_labels):
        raise AssertionError("pipeline: cli.test disagrees with the hook")
    # phase 26's CLI run: --shard-cameras on one card, the one-device path
    sharded, text = _run_cli(cli_test.main, [
        "transcar_r101", os.path.join(w2, "checkpoints", "6"),
        "--shard-cameras", "--out", os.path.join(tmp, "test_cam.json"),
        "--cfg-options", *data])
    said = [line for line in text.splitlines()
            if line.startswith("[shard-cameras]")]
    same = all(np.array_equal(sharded.detections[k], a[k])
               for k in ("boxes", "scores", "labels", "valid"))
    print(f"pipeline cli.test --shard-cameras on {torch.cuda.device_count()} "
          f"card: {said}, rows bit for bit those of cli.test {same}")
    if len(said) != 1 or "one-device path" not in said[0] or not same:
        raise AssertionError("pipeline: cli.test --shard-cameras")
    _pipeline_tta_runs(tmp, data, os.path.join(w2, "checkpoints", "6"), res,
                       n_dcn, smi)


def _pipeline_tta_runs(tmp: str, data: list, ckpt: str, plain, n_dcn: int,
                       smi: str) -> None:
    """Runs 5-7 of the pipeline phase: ``cli.test --aug-test`` on the
    checkpoint the hook evaluated.  ``--aug-test identity`` equals the
    plain ``cli.test`` rows (``plain``) bit for bit (a mean over one
    view); ``--aug-test`` (identity, flip) runs the camera forward twice a
    sample (52 K1) and the head once (3 K2), with finite native metrics;
    the same with ``quantize=int8`` runs 156 int8 convs a sample."""
    import numpy as np

    from transcar_tpu_torch.cli import test as cli_test
    from transcar_tpu_torch.core.config import get_preset, parse_overrides
    from transcar_tpu_torch.eval.metrics import evaluate_native
    from transcar_tpu_torch.ops import int8

    cfg = get_preset("transcar_r101", parse_overrides(data))
    per_view = INT8_SLICES["transcar_r101"]["int8_conv"]             # 78

    def run(name, extra, options=()):
        _zero_counts()
        t0 = time.perf_counter()
        res = cli_test.main(["transcar_r101", ckpt, "--out",
                             os.path.join(tmp, f"{name}.json"), *extra,
                             "--cfg-options", *data, *options])
        return (res, {**_pipeline_counts(), "int8": int8.launches},
                time.perf_counter() - t0)

    ident, got, dt = run("tta_identity", ["--aug-test", "identity"])
    n = len(ident.detections["tokens"])
    _want(f"transcar_r101 cli.test --aug-test identity ({n} samples)", got,
          {"K1": n_dcn * n, "K1 wgmma": n_dcn * n, "K2": 3 * n,
           "K2 wgmma": 3 * n, "int8": 0})
    same = all(np.array_equal(ident.detections[k], plain.detections[k])
               for k in ("boxes", "scores", "labels", "valid"))
    print(f"pipeline cli.test --aug-test identity = plain cli.test bit for "
          f"bit: {same} ({dt:.1f} s)")
    if not same:
        raise AssertionError("pipeline: --aug-test identity differs from "
                             "the plain cli.test")
    for name, options, int8_per_view in (("tta", (), 0),
                                         ("tta_int8", INT8_OPTS, per_view)):
        res, got, dt = run(name, ["--aug-test"], options)
        _want(f"transcar_r101 cli.test --aug-test {list(options)} ({n} "
              f"samples)", got,
              {"K1": 2 * n_dcn * n, "K1 wgmma": 2 * n_dcn * n,
               "K2": 3 * n, "K2 wgmma": 3 * n,
               "int8": 2 * int8_per_view * n})
        metrics = evaluate_native(res.path, ann_file=os.path.join(
            cfg.data.data_root, cfg.data.ann_val))
        finite = (np.isfinite(res.detections["boxes"]).all()
                  and all(math.isfinite(v) for v in metrics.values()))
        moved = not np.array_equal(res.detections["scores"],
                                   plain.detections["scores"])
        print(f"pipeline cli.test --aug-test (identity, flip) "
              f"{list(options)}: {dt:.1f} s for {n} samples, boxes and "
              f"native metrics finite {finite} ({metrics}), scores differ "
              f"from the plain run {moved} on {smi}")
        if not finite or not moved:
            raise AssertionError(f"pipeline --aug-test {list(options)}: "
                                 f"finite {finite}, moved {moved}")


def _pipeline_lidar_run(tmp: str, data: list, smi: str) -> None:
    """Run 5 of the pipeline phase: ``objdgcnn_pillar`` through the point
    loader, two steps and the eval hook on one sample."""
    from transcar_tpu_torch.cli import train as cli_train

    w5 = os.path.join(tmp, "w_pillar")
    _zero_counts()
    state = cli_train.main(["objdgcnn_pillar", "--work-dir", w5,
                            "--max-steps", "2", "--eval-samples", "1",
                            "--log-interval", "1", "--cfg-options", *data])
    got = _pipeline_counts()
    st = _step_stats(_train_records(w5))
    n_eval = len(state.last_eval.detections["tokens"])
    k = 8 * st["steps"]
    _want(f"objdgcnn_pillar train ({st['steps']} steps) + eval hook "
          f"({n_eval} sample)", got,
          {"K7": k + 8 * n_eval, "K7 group": k + 8 * n_eval, "K8": k,
           "K8 group": k, "K9": k, "K1": 0, "K2": 0})
    print(f"pipeline objdgcnn_pillar train: {st['ms_per_step']:.1f} ms a "
          f"step after the first (each {st['ms_each']} ms, of it loader "
          f"wait {st['wait_ms_each']} ms), loader wait "
          f"{st['loader_wait_s']:.3f} s "
          f"over {st['steps']} steps, peak {st['peak_gib']:.2f} GiB, "
          f"losses finite {st['finite']} on {smi}")
    if not st["finite"] or st["steps"] != 2 or n_eval != 1:
        raise AssertionError(f"pipeline objdgcnn_pillar: {st}")


# --- the tools on the pipeline's fixture (phase 20, last part) ---------------

#: The exported programs the tools phase loads and runs: a name → (preset,
#: the configuration's --cfg-options, kernel launches a request, each on
#: its main tile: every K1 on the Hopper tile, every K2 on the tensor-core
#: kernel, every K4 on the wgmma tile (K5's reduce counts as a K4), every
#: K5 chain conv and K6 call on theirs, every K7 on the lane-group kernel,
#: 77 of R101's 78 int8 convs on the wgmma tile, the stem on the mma.sync
#: one, and nothing else; the ``transcar`` ops its graph calls).  Eager's
#: launches in the same process must be the same.
EXPORTS = {
    "transcar_r101": ("transcar_r101", [], {
        "K1": 26, "K1 tile": 26, "K2": 3, "K2 tile": 3},
        ("dcn_forward", "masked_attention")),
    "transcar_vovnet_trainval": ("transcar_vovnet_trainval", [], {
        "K2": 3, "K2 tile": 3, "K4": 16, "K4 tile": 16},
        ("masked_attention", "osa_reduce")),
    "objdgcnn_pillar": ("objdgcnn_pillar", [], {"K7": 8, "K7 tile": 8},
                        ("msdeform_forward",)),
    "transcar_r101 int8": ("transcar_r101", [
        "model.backbone.quantize=int8"], {
        "K1": 26, "K1 tile": 26, "K2": 3, "K2 tile": 3, "int8 conv": 78,
        "int8 tile": 77, "int8 codes": 74, "int8 amax": 60},
        ("dcn_forward", "int8_amax", "int8_codes", "int8_conv",
         "masked_attention")),
    "transcar_vovnet_trainval osa_fused": ("transcar_vovnet_trainval", [
        "model.backbone.osa_reduce_impl=fused"], {
        "K2": 3, "K2 tile": 3, "K4": 16, "K4 tile": 16, "K5": 16,
        "K5 tile": 80}, ("masked_attention", "osa_block")),
    "transcar_r101 block_fused": ("transcar_r101", [
        "model.backbone.block_impl=fused"], {
        "K1": 26, "K1 tile": 26, "K2": 3, "K2 tile": 3, "K6": 6,
        "K6 tile": 6}, ("bottleneck", "dcn_forward", "masked_attention")),
}
#: The loaded programs held bit for bit to the live eval step (max |Δ| of
#: each decoded output 0, the labels equal), and two eager requests to
#: each other: every program runs the same ops on the same kernels in the
#: same order as eager, and every kernel sums in one fixed order (VoVNet's
#: K4, also as K5's reduce, its eSE channel sums too:
#: ``csrc/ordered_sum.cuh``).  All six.
EXPORT_EXACT = tuple(EXPORTS)
#: The parity round trip on the card (the JAX self-test's tolerances).
PARITY_TOL = {"box": 1e-4, "score": 1e-5}


def _tool_counts() -> dict:
    """The launch counters an exported program's kernels add to, by name;
    zero ones left out."""
    from transcar_tpu_torch.ops import (int8, pallas_attention,
                                        pallas_bottleneck, pallas_dcn,
                                        pallas_msdeform, pallas_osa,
                                        pallas_osa_block)

    got = {"K1": pallas_dcn.launches, "K1 tile": pallas_dcn.wgmma_launches,
           "K2": pallas_attention.launches,
           "K2 tile": pallas_attention.mma_launches,
           "K4": pallas_osa.launches, "K4 tile": pallas_osa.wgmma_launches,
           "K5": pallas_osa_block.launches,
           "K5 tile": pallas_osa_block.wgmma_launches,
           "K6": pallas_bottleneck.launches,
           "K6 tile": pallas_bottleneck.wgmma_launches,
           "K7": pallas_msdeform.launches,
           "K7 tile": pallas_msdeform.group_launches,
           "int8 conv": int8.launches, "int8 tile": int8.wgmma_launches,
           "int8 codes": int8.quantize_launches,
           "int8 amax": int8.amax_launches}
    return {k: v for k, v in got.items() if v}


def _device_kernels(fn, path: str) -> tuple:
    """(device kernels, device busy ms) of one call of ``fn``, from a
    torch.profiler trace written to ``path`` and removed."""
    from torch.profiler import ProfilerActivity, profile

    from transcar_tpu_torch.cli.benchmark import trace_summary

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    summary = trace_summary(path, 1.0, 1)
    os.remove(path)
    return int(summary["kernels_per_iter"]), \
        summary["device_busy_ms_per_iter"]


def _latest_step(work_dir: str):
    steps = sorted(int(p.name) for p in pathlib.Path(
        work_dir, "checkpoints").glob("*") if p.name.isdigit())
    return os.path.join(work_dir, "checkpoints", str(steps[-1])) \
        if steps else None


def _program_batch(cfg, device) -> dict:
    """The fixture's first val sample through the eval loader, on the
    card and normalized: the exported program's input."""
    import numpy as np

    from transcar_tpu_torch.cli.train import _try_radar_fn
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.data.infos import NuScenesInfos
    from transcar_tpu_torch.data.loader import PrefetchLoader, to_device
    from transcar_tpu_torch.train.step import normalize_batch_images

    ann = get_preset("transcar_r101").data.ann_val       # the fixture's
    ds = NuScenesInfos(os.path.join(cfg.data.data_root, ann),
                       class_names=cfg.data.class_names, test_mode=True,
                       data_root=cfg.data.data_root)
    lidar = bool(cfg.model.lidar_encoder)
    loader = PrefetchLoader(
        ds, cfg.data, batch_size=1, training=False, indices=np.arange(1),
        radar_fn=(_try_radar_fn(cfg) if cfg.model.head.with_radar_fusion
                  else None), modality="lidar" if lidar else "camera")
    batch = next(iter(loader.epoch(0)))
    batch = normalize_batch_images(to_device(batch, device), cfg.data)
    keys = (("points", "num_points") if lidar else
            ("images", "lidar2img", "radar_tokens"))
    return {k: batch[k] for k in keys if k in batch}


def export_child(name: str, tmp: str, ckpt: str, data: list) -> None:
    """One exported program of :data:`EXPORTS`, in a process of its own
    (``--export-child``; :func:`phase_tools` runs them side by side, as
    tracing is host work): ``cli.export`` of its preset and options at
    full width into ``tmp``, the ``.pt2`` loaded and the live eval step
    built on the same weights (the checkpoint ``ckpt``, or ``-`` for the
    seeded ones, folded), then ``ready`` on stdout and a wait for a line on
    stdin, so that the card and the host are this process's alone while it
    runs the fixture batch through both: max |Δ| a decoded output,
    launches of each, device kernels of each (a profiled request: a
    program that rebuilt or re-quantized a weight would launch more), ms
    a request in turns with eager.  Prints its report as one JSON line and
    raises on a failed check."""
    import sys

    from transcar_tpu_torch.cli import export as cli_export
    from transcar_tpu_torch.core.config import get_preset, parse_overrides
    from transcar_tpu_torch.models.detector import build_model
    from transcar_tpu_torch.train.fold import (fold_bn_into_conv,
                                               frozen_bn_names)
    from transcar_tpu_torch.train.loop import _load_params
    from transcar_tpu_torch.train.step import eval_step

    preset, options, want, want_ops = EXPORTS[name]
    ckpt = None if ckpt == "-" else ckpt
    out = os.path.join(tmp, f"{name.replace(' ', '_')}.pt2")
    t0 = time.perf_counter()
    cli_export.main([preset, "--out", out,
                     *(["--checkpoint", ckpt] if ckpt else []),
                     "--cfg-options", *data, *options])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = torch.export.load(out).module()
    load_s = time.perf_counter() - t0
    sidecar = json.loads(pathlib.Path(out + ".json").read_text())
    graph_ops = sorted({str(n.target) for n in program.graph.nodes
                        if str(n.target).startswith("transcar.")})
    held = sum(1 for k, _ in program.named_buffers() if "_held" in k)
    cfg = get_preset(preset, parse_overrides([*data, *options]))
    model = build_model(cfg)
    if ckpt:
        model.load_state_dict(_load_params(ckpt, cfg, model))
    model.load_state_dict(fold_bn_into_conv(model.state_dict(),
                                            frozen_bn_names(model)))
    batch = _program_batch(cfg, torch.device("cuda"))
    print("ready", flush=True)
    sys.stdin.readline()
    with torch.inference_mode():
        _zero_counts()
        got = program(batch)
        torch.cuda.synchronize()
        counts = _tool_counts()
        _zero_counts()
        ref = eval_step(model, batch, cfg)
        torch.cuda.synchronize()
        eager_counts = _tool_counts()
        again = eval_step(model, batch, cfg)
        err = {k: (got[k].double() - ref[k].double()).abs().max().item()
               for k in ("boxes", "scores")}
        rep = {k: (again[k].double() - ref[k].double()).abs().max().item()
               for k in ("boxes", "scores")}
        labels = [int((got["labels"] != ref["labels"]).sum()),
                  int((again["labels"] != ref["labels"]).sum())]
        same_valid = bool(torch.equal(got["valid"], ref["valid"]))
        trace = os.path.join(tmp, f"{name.replace(' ', '_')}.trace.json")
        kernels = {"eager": _device_kernels(
                       lambda: eval_step(model, batch, cfg), trace),
                   "exported": _device_kernels(lambda: program(batch),
                                               trace)}
        turns = [cuda_ms(f, iters=5, warmup=1) for f in (
            lambda: eval_step(model, batch, cfg), lambda: program(batch),
            lambda: program(batch), lambda: eval_step(model, batch, cfg))]
    exact = name in EXPORT_EXACT
    bound = {k: 0.0 if exact else 2 * max(v, 1e-4) for k, v in rep.items()}
    # an exact program's eager twin repeats itself bit for bit too
    rep_ok = not exact or (max(rep.values()) == 0.0 and labels[1] == 0)
    outputs = cli_export.tree_doc(got)
    report = {
        "name": name, "preset": preset, "options": options,
        "export_s": export_s, "load_s": load_s,
        "mib": os.path.getsize(out) / 2**20, "graph_ops": graph_ops,
        "held": held, "max_abs": err, "bound": bound, "exact": exact,
        "eager_repeat_max_abs": rep,
        "labels_differing": labels[0], "eager_repeat_labels": labels[1],
        "valid_equal": same_valid,
        "finite": bool(torch.isfinite(got["boxes"]).all()),
        "outputs_as_sidecar": outputs == sidecar["outputs"],
        "launches": counts, "eager_launches": eager_counts, "want": want,
        "device_kernels": kernels,
        "eager_ms": [turns[0], turns[3]], "exported_ms": turns[1:3]}
    print(json.dumps(report), flush=True)
    if not (counts == eager_counts == want
            and kernels["exported"][0] <= kernels["eager"][0]
            and all(err[k] <= bound[k] for k in err) and rep_ok
            and report["finite"] and same_valid
            and labels[0] <= (0 if exact else labels[1])
            and report["outputs_as_sidecar"]
            and graph_ops == [f"transcar.{op}.default" for op in want_ops]):
        raise AssertionError(f"tools export {name}: the loaded program "
                             f"disagrees with the eval step, launched other"
                             f" kernels than eager, or missed its kernels")


def _start_export_children(tmp: str, data: list, ckpts: dict) -> dict:
    """One :func:`export_child` a program of :data:`EXPORTS`, all started
    together (``ckpts``: name → checkpoint or None)."""
    import sys

    script = str(pathlib.Path(__file__).resolve())
    return {name: subprocess.Popen(
        [sys.executable, script, "--export-child", name, tmp,
         ckpt or "-", *data], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, ckpt in ckpts.items()}


def _finish_export_child(name: str, proc, smi: str) -> None:
    """Wait for the child's ``ready``, let it run, print its report."""
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.strip() == "ready":
                break
        proc.stdin.write("go\n")
        proc.stdin.flush()
        lines += proc.stdout.readlines()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reports = [json.loads(line) for line in lines if line.startswith("{")]
    if rc != 0 or not reports:
        print("".join(lines[-40:]), flush=True)
        raise AssertionError(f"tools export {name}: child exited {rc}")
    r = reports[-1]
    kern = r["device_kernels"]
    print(f"tools export {name}: cli.export {r['export_s']:.1f} s "
          f"({len(EXPORTS)} programs side by side), torch.export.load "
          f"{r['load_s']:.1f} s, {r['mib']:.1f} MiB, {r['held']} derived "
          f"tensors held as state; graph ops {r['graph_ops']}; the loaded "
          f"program against the live eval step: max |Δ| {r['max_abs']} "
          f"(bound {r['bound']}: "
          f"{'bit for bit' if r['exact'] else 'within the eager repeat'}; "
          f"eager against eager {r['eager_repeat_max_abs']}), labels "
          f"differing {r['labels_differing']} (eager repeat "
          f"{r['eager_repeat_labels']}), valid equal {r['valid_equal']}, "
          f"finite {r['finite']}, outputs as the sidecar's "
          f"{r['outputs_as_sidecar']}; launches a request {r['launches']}, "
          f"eager {r['eager_launches']} (want {r['want']}); device kernels "
          f"a request exported {kern['exported'][0]} "
          f"({kern['exported'][1]:.2f} ms busy), eager {kern['eager'][0]} "
          f"({kern['eager'][1]:.2f} ms busy); ms a request eager "
          f"{r['eager_ms'][0]:.2f} / {r['eager_ms'][1]:.2f}, exported "
          f"{r['exported_ms'][0]:.2f} / {r['exported_ms'][1]:.2f} (exported"
          f" / eager {min(r['exported_ms']) / min(r['eager_ms']):.3f}) on "
          f"{smi}", flush=True)


def phase_tools(tmp: str, data: list, smi: str) -> None:
    """The tools on the pipeline phase's fixture and work dirs: ``cli.export``
    of the six programs of :data:`EXPORTS` (three presets, and int8,
    fused-OSA and fused-bottleneck serving), each in a process of its own
    started first (:func:`export_child`); meanwhile ``cli.test
    --show-dir``, the ``parity_check`` capture → compare round trip,
    ``get_flops`` of the six presets at full width (and of the opt-in
    configurations beside their twins), ``publish_model`` of the
    ``transcar_r101`` run, ``print_config`` and ``analyze_logs`` on its
    json log; then each program's run on the card, one at a time."""
    t_phase = time.perf_counter()
    w2 = os.path.join(tmp, "w_transcar")
    ckpt6 = os.path.join(w2, "checkpoints", "6")
    pillar = _latest_step(os.path.join(tmp, "w_pillar"))
    children = _start_export_children(tmp, data, {
        name: (ckpt6 if preset == "transcar_r101" else
               pillar if preset == "objdgcnn_pillar" else None)
        for name, (preset, *_) in EXPORTS.items()})
    try:
        _host_tools(tmp, data, w2, ckpt6)
        for name, proc in children.items():
            _finish_export_child(name, proc, smi)
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"tools phase: {time.perf_counter() - t_phase:.1f} s on {smi}")


def _host_tools(tmp: str, data: list, w2: str, ckpt6: str) -> None:
    """The tools phase's CLIs besides ``cli.export`` (see
    :func:`phase_tools`)."""
    import csv

    from transcar_tpu_torch.cli import (analyze_logs, get_flops,
                                        parity_check, print_config,
                                        publish_model)
    from transcar_tpu_torch.cli import test as cli_test
    from transcar_tpu_torch.cli.train import _try_radar_fn
    from transcar_tpu_torch.core.config import (config_to_dict, get_preset,
                                                list_presets,
                                                parse_overrides)
    from transcar_tpu_torch.models.detector import build_model
    from transcar_tpu_torch.train import checkpoint as ckpt_io
    from transcar_tpu_torch.train.loop import _load_params

    # cli.test --show-dir: one BEV PNG a sample
    show = os.path.join(tmp, "show")
    res = cli_test.main(["transcar_r101", ckpt6, "--out",
                         os.path.join(tmp, "show.json"), "--show-dir", show,
                         "--cfg-options", *data])
    pngs = sorted(pathlib.Path(show).glob("*.png"))
    n = len(res.detections["tokens"])
    print(f"tools cli.test --show-dir: {len(pngs)} PNGs for {n} samples, "
          f"{[p.stat().st_size for p in pngs]} bytes")
    if len(pngs) != n or not all(p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
                                 for p in pngs):
        raise AssertionError("tools: --show-dir wrote no PNG a sample")

    # parity_check: capture on the card, then the CLI compares
    cfg = get_preset("transcar_r101", parse_overrides(data))
    model = build_model(cfg)
    model.load_state_dict(_load_params(ckpt6, cfg, model))
    npz = os.path.join(tmp, "capture.npz")
    t0 = time.perf_counter()
    parity_check.capture_outputs(cfg, model, npz,
                                 radar_fn=_try_radar_fn(cfg))
    capture_s = time.perf_counter() - t0
    report_path = os.path.join(tmp, "parity.json")
    rc, text = _run_cli(parity_check.main, [
        "transcar_r101", "--checkpoint", ckpt6, "--reference-npz", npz,
        "--box-tol", str(PARITY_TOL["box"]), "--score-tol",
        str(PARITY_TOL["score"]), "--report-out", report_path,
        "--cfg-options", *data])
    report = json.loads(pathlib.Path(report_path).read_text())
    print(f"tools parity_check round trip: capture {capture_s:.1f} s, "
          f"{report['n_samples']} samples, {report['compared_rows']} rows: "
          f"box max |Δ| {report['box_max_abs']:.3g}, score max |Δ| "
          f"{report['score_max_abs']:.3g} (tol {PARITY_TOL}), labels "
          f"{report['label_agree_min']}, rc {rc}")
    if rc != 0 or "PARITY PASSED" not in text or not report["n_samples"]:
        raise AssertionError("tools: the parity round trip failed")
    del model

    # get_flops at full width, every preset (on the meta device)
    t0 = time.perf_counter()
    flops = {p: get_flops.count_flops(get_preset(p), 928, 1600)
             for p in list_presets()}
    print(f"tools get_flops ({time.perf_counter() - t0:.1f} s): "
          + "; ".join(f"{p} {r['gflops']} GFLOP, {r['params_m']} M params, "
                      f"kernels {r['kernel_gflops']}"
                      for p, r in flops.items()))
    if not all(r["gflops"] > 0 and r["params_m"] > 0 and r["kernel_gflops"]
               for r in flops.values()):
        raise AssertionError(f"tools: get_flops {flops}")
    # the opt-in serving configurations count their twins' totals
    for name, (preset, options, _, _) in EXPORTS.items():
        if options:
            r = get_flops.count_flops(
                get_preset(preset, parse_overrides(options)), 928, 1600)
            print(f"tools get_flops {name}: {r['gflops']} GFLOP (twin "
                  f"{flops[preset]['gflops']}), kernels {r['kernel_gflops']}")
            if r["gflops"] != flops[preset]["gflops"]:
                raise AssertionError(f"tools: get_flops {name} {r}")

    # publish_model, print_config, analyze_logs
    pub, _ = _run_cli(publish_model.main, [w2, os.path.join(tmp, "pub",
                                                            "transcar")])
    published = torch.load(pub, map_location="cpu", weights_only=True)
    latest = ckpt_io.load_params_only(_latest_step(w2))
    same = (list(published) == list(latest) and all(
        torch.equal(published[k], latest[k]) for k in latest))
    digest = publish_model.state_digest(latest)[:8]
    _, text = _run_cli(print_config.main, ["transcar_r101"])
    printed = json.loads(text) == json.loads(json.dumps(config_to_dict(
        get_preset("transcar_r101"))))
    log = sorted(pathlib.Path(w2).glob("*.log.json"))[0]
    train_recs = [r for r in analyze_logs.load_records(log)
                  if r.get("mode") == "train" and "total" in r]
    _, timing = _run_cli(analyze_logs.main, ["cal_train_time", str(log)])
    curve = os.path.join(tmp, "curve.png")
    _, plotted = _run_cli(analyze_logs.main, [
        "plot_curve", str(log), "--keys", "total", "--out", curve])
    wrote = curve if os.path.exists(curve) else curve[:-4] + ".csv"
    rows = (len(list(csv.reader(open(wrote)))) - 1
            if wrote.endswith(".csv") else None)
    print(f"tools publish_model: {os.path.basename(pub)} (hash {digest}), "
          f"equal to the latest step's state {same}; print_config JSON = "
          f"config_to_dict {printed}; analyze_logs: cal_train_time "
          f"{'overall mean' in timing}, plot_curve wrote "
          f"{os.path.basename(wrote)} ({rows} rows for {len(train_recs)} "
          f"train records)")
    if (not same or not pub.endswith(digest) or not printed
            or "overall mean" not in timing
            or (rows is not None and rows != len(train_recs))):
        raise AssertionError("tools: publish_model / print_config / "
                             "analyze_logs")


# --- int8 serving (phases 21 and 22) -----------------------------------------

#: int8 convolutions, and the kernels beside them, a bs1 request of each
#: int8 serving slice.  R101 (DCN in stages 3-4, 3/4/23/3 blocks): the stem
#: + 33 conv1 + 33 conv3 + 7 non-DCN conv2 + 4 downsample = 78 convs, all
#: but the stem (Cin = 3) on the wgmma tile (77), beside 26 K1 and 3 K2;
#: 74 codes passes (the 4 downsamples share conv1's) and 60 standalone
#: amax passes (the stem, 33 conv1 and the 26 conv3 after a DCN; the 7
#: non-DCN conv2 and conv3 take the amax of the epilogue before them).
#: VoVNet-99 with the K4 tail: 3 stem convs + 16 blocks x 5 chain convs =
#: 83, all but stem1 on the wgmma tile (82), beside 16 K4 and 3 K2; 83
#: codes passes and 17 amax passes (stem1 and the 16 blocks' conv0; chain
#: convs 1-4 and stems 2-3 take their producer's).  The concat reduce stays
#: bf16 on K4, as on the TPU.
INT8_SLICES = {
    "transcar_r101": {"int8_conv": 78, "int8_wgmma": 77, "int8_quantize": 74,
                      "int8_amax": 60, "dcn_forward": 26,
                      "masked_attention": 3},
    "transcar_vovnet_trainval": {"int8_conv": 83, "int8_wgmma": 82,
                                 "int8_quantize": 83, "int8_amax": 17,
                                 "osa_reduce": 16, "masked_attention": 3},
}
INT8_OPTS = ("model.backbone.quantize=int8",)
#: Each FPN level's cosine against the bf16 path at the seeded weights and
#: batch, as the first int8 kernels gave it (the range over the levels; the
#: outputs are bit for bit those): each level stays inside it to 1e-5.
INT8_FPN_COS = {"transcar_r101": (0.99880, 0.99925),
                "transcar_vovnet_trainval": (0.99948, 0.99991)}


def int8_main_shapes() -> dict:
    """{preset: {(N, Cin, H, W, Cout, k, stride, padding): calls a
    request}} of the int8 convs of the two slices at 6 x 928 x 1600, from
    the architectures (phase 21 checks the recorded calls against it)."""
    r101, n = {}, 6

    def add(table, *shape, calls=1):
        key = (n, *shape)
        if calls:
            table[key] = table.get(key, 0) + calls

    add(r101, 3, 928, 1600, 64, 7, 2, 3)
    h, w, cin = 232, 400, 64
    for planes, blocks, stride, dcn in ((64, 3, 1, False), (128, 4, 2, False),
                                        (256, 23, 2, True),
                                        (512, 3, 2, True)):
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        add(r101, cin, h, w, planes, 1, stride, 0)                # conv1
        add(r101, cin, h, w, 4 * planes, 1, stride, 0)            # downsample
        add(r101, 4 * planes, ho, wo, planes, 1, 1, 0, calls=blocks - 1)
        if not dcn:
            add(r101, planes, ho, wo, planes, 3, 1, 1, calls=blocks)
        add(r101, planes, ho, wo, 4 * planes, 1, 1, 0, calls=blocks)
        h, w, cin = ho, wo, 4 * planes
    vov = {}
    add(vov, 3, 928, 1600, 64, 3, 2, 1)
    add(vov, 64, 464, 800, 64, 3, 1, 1)
    add(vov, 64, 464, 800, 128, 3, 2, 1)
    h, w, cin = 232, 400, 128
    for si, (ch, out, blocks) in enumerate(((128, 256, 1), (160, 512, 3),
                                            (192, 768, 9), (224, 1024, 3))):
        if si > 0:
            h, w = h // 2, w // 2
        add(vov, cin, h, w, ch, 3, 1, 1)
        add(vov, out, h, w, ch, 3, 1, 1, calls=blocks - 1)
        add(vov, ch, h, w, ch, 3, 1, 1, calls=4 * blocks)
        cin = out
    return {"transcar_r101": r101, "transcar_vovnet_trainval": vov}


def _record_int8_calls() -> tuple:
    """Wrap the int8 conv, amax and codes kernel wrappers (which the
    registered ops' CUDA implementations call) so that each call records
    its shape: the conv's (N, Cin, H, W, Cout, k, stride, padding) with its
    epilogue flags (affine, relu, amax taken), and each codes pass's (N,
    C, H, W) with whether its amax came with it (no amax pass ran for it).
    Returns the two lists and a function that unwraps them."""
    from transcar_tpu_torch.ops import int8

    convs, quants, amax_pass = [], [], []
    conv, amax_kernel, codes = (int8.conv_kernel, int8.amax_kernel,
                                int8.codes_kernel)

    def recording_conv(xq, s_x, weight_q, stride=1, padding=0, dilation=1,
                       out_dtype=torch.bfloat16, affine=None, relu=False,
                       want_amax=False):
        n, _, h, w = xq.shape
        cout, cin, k, _ = weight_q.q.shape
        convs.append(((n, cin, h, w, cout, k, stride, padding),
                      (affine is not None, relu, want_amax)))
        return conv(xq, s_x, weight_q, stride, padding, dilation, out_dtype,
                    affine, relu, want_amax)

    def recording_amax(x):
        amax_pass.append(True)
        return amax_kernel(x)

    def recording_codes(x, amax, channels=None):
        quants.append((tuple(x.shape), not amax_pass))
        amax_pass.clear()
        return codes(x, amax, channels)

    int8.conv_kernel, int8.amax_kernel, int8.codes_kernel = (
        recording_conv, recording_amax, recording_codes)

    def unwrap():
        int8.conv_kernel, int8.amax_kernel, int8.codes_kernel = (
            conv, amax_kernel, codes)
    return convs, quants, unwrap


def _per_request(calls: list, n_req: int) -> dict:
    counts = {}
    for c in calls:
        counts[c] = counts.get(c, 0) + 1
    if any(k % n_req for k in counts.values()):
        raise AssertionError(f"int8 calls {counts} are not the same in each "
                             f"of {n_req} requests")
    return {c: k // n_req for c, k in counts.items()}


def _fpn_levels(preset: str, options) -> list:
    """The FPN levels ([B, N, h, w, C] float32) of ``benchmark``'s seeded
    model and synthetic batch for ``preset``."""
    from transcar_tpu_torch.cli import benchmark

    args = benchmark.parse_args([preset, "--cfg-options", *options])
    _, model, batch, _ = benchmark._setup(args, training=False)
    b, n, h, w, _ = batch["images"].shape
    with torch.inference_mode():
        feats = model._features(batch["images"].reshape(b * n, h, w, 3), b,
                                n)
    del model, batch
    return feats


def phase_int8_slices(smi: str) -> tuple:
    """``transcar_r101`` and ``transcar_vovnet_trainval`` bs1 serving at
    full width with ``model.backbone.quantize=int8`` through
    ``cli.benchmark``: launches per request against :data:`INT8_SLICES`
    (the wgmma tile's, the codes and the standalone amax passes among
    them), the conv shapes against :func:`int8_main_shapes`, every conv
    with FrozenBN folded into its epilogue, finite outputs and decode, ms a
    request and peak memory beside the bf16 path in this call, each FPN
    level's cosine and relative error against the bf16 path at the same
    seeded weights (inside :data:`INT8_FPN_COS`), and no host sync in a
    warm int8 request.  Returns (launches of the runs by kernel, summed
    over both presets; {preset: {conv shape: calls a request}}; {preset:
    {(quantize shape, amax given): calls a request}})."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.core.config import get_preset
    from transcar_tpu_torch.ops import int8

    launches, shapes, quants = {}, {}, {}
    arch = int8_main_shapes()
    for preset, per_req in INT8_SLICES.items():
        cfg = get_preset(preset)
        _zero_counts()
        convs, qcalls, unwrap = _record_int8_calls()
        try:
            rec, out = benchmark.run([preset, "--samples", "5", "--warmup",
                                      "2", "--cfg-options", *INT8_OPTS])
        finally:
            unwrap()
        n_req = rec["requests"]
        got = rec["kernel_launches"]
        want = {k: per_req.get(k, 0) * n_req for k in got}
        valid = _check_outputs(f"int8 {preset}", out, cfg)
        per_conv = _per_request(convs, n_req)
        shapes[preset] = _per_request([c for c, _ in convs], n_req)
        quants[preset] = _per_request(qcalls, n_req)
        paths = {}
        for shape, calls in shapes[preset].items():
            path = "wgmma" if int8.takes_wgmma(shape[1], shape[4]) else "mma"
            paths[path] = paths.get(path, 0) + calls
        print(f"int8 slice {preset} 6x928x1600 bs1: {n_req} requests, "
              f"launches {got} (want {per_req} a request, no other kernel), "
              f"{len(shapes[preset])} distinct int8 conv shapes (convs a "
              f"request by tile {paths}); epilogues (affine, relu, amax) "
              f"{sorted({f for _, f in per_conv})}; quantize calls a request "
              f"{sum(quants[preset].values())}, "
              f"{sum(k for (_, a), k in quants[preset].items() if a)} from "
              f"an epilogue's amax; outputs finite; decode {valid}/300 valid "
              f"boxes")
        if got != want or shapes[preset] != arch[preset]:
            raise AssertionError(f"int8 slice {preset}: launches {got} != "
                                 f"{want}, or shapes {shapes[preset]} != "
                                 f"{arch[preset]}")
        if not all(f[0] for _, f in per_conv):
            raise AssertionError(f"int8 slice {preset}: a conv without its "
                                 f"FrozenBN in the epilogue")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        base, _ = benchmark.run([preset, "--samples", "5", "--warmup", "2"])
        for name, r in (("int8", rec), ("bf16", base)):
            print(f"int8 slice {preset} {name} path: "
                  f"{r['ms_per_sample']:.2f} ms a request "
                  f"({r['samples_per_sec']:.3f} samples/s), peak memory "
                  f"{r['peak_memory_bytes'] / 2**30:.2f} GiB on {smi}")
        for name, opts in (("int8", INT8_OPTS), ("bf16", ())):
            t = _traced_request(preset, opts)
            if not t["kernels_per_iter"]:     # the profiler kept no kernel
                t = _traced_request(preset, opts)
            if not t["kernels_per_iter"]:
                print(f"int8 slice {preset} {name} path traced: the profiler "
                      f"recorded no kernel twice (device time not measured)")
                continue
            groups = t["ms_per_iter_by_group"]
            print(f"int8 slice {preset} {name} path traced (5 requests): "
                  f"device busy {t['device_busy_ms_per_iter']:.2f} ms a "
                  f"request, idle share {t['device_idle_share']:.3f}, "
                  f"{t['kernels_per_iter']:.0f} kernels a request; ms a "
                  f"request by group " + ", ".join(
                      f"{g} {v:.3f}" for g, v in groups.items()), flush=True)
        q = _fpn_levels(preset, INT8_OPTS)
        f = _fpn_levels(preset, ())
        parts = []
        lo, hi = INT8_FPN_COS[preset]
        for i, (a, b) in enumerate(zip(q, f)):
            a, b = a.double().flatten(), b.double().flatten()
            cos = (a @ b / (a.norm() * b.norm())).item()
            rel = ((a - b).norm() / b.norm()).item()
            parts.append(f"P{i}: cos {cos:.6f}, rel {rel:.4f}")
            if not (math.isfinite(cos) and lo - 1e-5 <= cos <= hi + 1e-5):
                raise AssertionError(f"int8 slice {preset} FPN level {i}: "
                                     f"cosine {cos} against bf16, outside "
                                     f"[{lo}, {hi}] +- 1e-5")
        print(f"int8 slice {preset} FPN levels against the bf16 path (same "
              f"seeded weights and batch): " + "; ".join(parts))
        del q, f
        found = warm_request_syncs(preset, cfg_options=INT8_OPTS)
        print(f"int8 slice {preset} sync check (set_sync_debug_mode, armed) "
              f"warm bs1 request: "
              + ("no host sync ok" if not found else f"host syncs {found}"))
        if found:
            raise AssertionError(f"int8 {preset}: a serving request "
                                 f"synchronized with the host: {found}")
        torch.cuda.empty_cache()
    return launches, shapes, quants


def _traced_request(preset: str, options) -> dict:
    """``cli.benchmark --trace-dir`` of 5 bs1 requests of ``preset``: its
    ``summary.json`` (device busy ms and kernel groups a request); the
    chrome trace itself is deleted."""
    import tempfile

    from transcar_tpu_torch.cli import benchmark

    with tempfile.TemporaryDirectory() as tmp:
        rec, _ = benchmark.run([preset, "--samples", "5", "--warmup", "2",
                                "--trace-dir", tmp, "--cfg-options",
                                *options])
    return rec["trace"]


def _im2col(xq, k: int, stride: int, padding: int, kp: int):
    """The int8 codes [N, Cin, H, W] (channels-last) as the [M, Kp] matrix
    of the implicit GEMM (k = (ky·k + kx)·Cin + ci, zero past K)."""
    xh = xq.permute(0, 2, 3, 1)
    if padding:
        xh = torch.nn.functional.pad(xh, (0, 0, padding, padding, padding,
                                          padding))
    n, hp, wp, c = xh.shape
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    cols = [xh[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride] for ky in range(k)
            for kx in range(k)]
    a = torch.stack(cols, 3).reshape(n * ho * wo, k * k * c)
    return torch.nn.functional.pad(a, (0, kp - k * k * c)).contiguous()


def _flat_kmajor(q):
    """OIHW int8 codes as [Cout, Kp] with k = (ky·kw + kx)·Cin + ci, zero
    past K (Kp a multiple of 64): the first tile's layout for every Cin,
    which ``torch._int_mm`` on :func:`_im2col` and the parent take."""
    cout = q.shape[0]
    flat = q.permute(0, 2, 3, 1).reshape(cout, -1)
    return torch.nn.functional.pad(flat, (0, -flat.shape[1] % 64)).contiguous()


def parent_int8_conv(lib, xq, s_x, wq, stride: int, pad: int):
    """An earlier commit's int8 conv kernel (``lib.int8_conv``, the first
    ``mma.sync`` tile with the dequantize alone) on the same codes, scales
    and K-major weight codes, bfloat16 out."""
    n, cin, h, w = xq.shape
    cout, _, k, _ = wq.q.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    out = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device="cuda")
    rc = lib.int8_conv(
        *(ctypes.c_void_p(t.data_ptr()) for t in (xq, wq.kmajor, s_x,
                                                   wq.scale, out)),
        1, n, h, w, cin, cout, k, k, stride, pad, ho, wo,
        wq.kmajor.shape[1],
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"parent int8 conv: CUDA error {rc}")
    return out.permute(0, 3, 1, 2)


def parent_int8_quantize(lib, x):
    """An earlier commit's quantize pass (``lib.int8_quantize``: a memset,
    the amax and the codes kernels) on ``x``: (codes, scale)."""
    q = torch.empty_like(x, dtype=torch.int8)
    buf = torch.empty(2, dtype=torch.float32, device="cuda")
    rc = lib.int8_quantize(
        ctypes.c_void_p(x.data_ptr()), int(x.dtype == torch.bfloat16),
        ctypes.c_longlong(x.numel()), ctypes.c_void_p(buf[1].data_ptr()),
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(buf.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"parent int8 quantize: CUDA error {rc}")
    return q, buf[0]


def _int8_timer(f):
    return queued_ms(f, iters=10, warmup=2)


def phase_int8(shapes: dict, quants: dict, smi: str, parent=None) -> dict:
    """The int8 conv kernel and the quantize passes against their plain
    versions on the card at every distinct conv shape of the two int8
    slices (``shapes`` and ``quants`` from :func:`phase_int8_slices`),
    bfloat16 activations, bit for bit: the codes and scale (the amax and
    codes passes, and the codes pass from a given amax), the conv alone
    (the dequantize) and the conv with ConvBN's epilogue (FrozenBN's
    affine, ReLU) and its amax, each with the tile it took.  Per shape and
    per request of each slice (calls a request as weights), timed by
    :func:`queued_ms` (launches queued ahead of the device): the fused
    conv's ms (what the main path runs) beside cuDNN's bfloat16 conv plus
    the module's BN and ReLU passes (a stem's also beside the knock-out
    that runs it on the ``wgmma`` tile, its codes and weight zero-padded to
    16 channels, in turns); the conv alone beside the bound
    max(2·M·Cout·K / 1,979 TOPS, bytes / 3.35 TB/s), the bytes those of
    the codes its taps cover at its own Cin (N·min(H·W, k²·Ho·Wo)·Cin),
    the weight codes and scales and the output, ``torch._int_mm`` of
    an im2col of the same codes (the same int32 product; the im2col built
    outside the timing) and cuDNN's bfloat16 ``F.conv2d`` of the same shape
    (two yardsticks the port never calls); the amax and codes passes
    beside their bounds, per request as the main path runs them (a codes
    pass each quantize, an amax pass where no epilogue gave one).  With a
    ``parent`` library that has an int8 conv (the first tile), its conv
    and quantize kernels are held to these bit for bit and timed in turns
    with the conv alone and the amax + codes passes.  Returns the
    kernels-line entries of ``int8_conv`` (``ms`` the conv alone,
    ``fused_ms`` with the epilogue) and ``int8_quantize``, per
    ``transcar_r101`` request."""
    import torch.nn.functional as F

    from transcar_tpu_torch.ops import counts, int8

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    keys = ("ms", "conv_ms", "plain_ms", "bound_ms", "int_mm_ms", "cudnn_ms",
            "cudnn_bn_relu_ms", "parent_ms", "q_parent_ms", "stem_ms",
            "stem16_ms")
    qkeys = ("q_ms", "q_plain_ms", "q_bound_ms")
    parent = parent if parent is not None and hasattr(parent, "int8_conv") \
        else None
    totals = {p: dict.fromkeys(keys + qkeys, 0.0) for p in shapes}
    worst = {"conv": 0.0, "quantize": 0.0}
    kinds = set()
    t0 = time.perf_counter()
    counted = set()               # input shapes whose quantizes are summed
    for shape in sorted({s for per in shapes.values() for s in per}):
        n, cin, h, w, cout, k, stride, pad = shape
        path = "wgmma" if int8.takes_wgmma(cin, cout) else "mma"
        x = torch.randn(n, cin, h, w, device="cuda", generator=g).to(
            bf16).contiguous(memory_format=torch.channels_last)
        wt = torch.randn(cout, cin, k, k, device="cuda",
                         generator=g) / math.sqrt(k * k * cin)
        aff = _affine(g, cout)
        wq = int8.prepare_weight(wt)
        flat = _flat_kmajor(wq.q)
        cq = int8.code_channels(cin)        # a stem's codes: 4 channels
        xq, s_x = int8.quantize_kernel(x, channels=cq)
        xq_ref, s_ref = int8.plain_quantize_per_tensor(x)
        xq2, s_2 = int8.quantize_kernel(x, int8.plain_amax(x), cq)
        q_err = (xq[:, :cin].int() - xq_ref.int()).abs().max().item()
        q_same = (q_err == 0 and s_x.item() == s_ref.item()
                  and not xq[:, cin:].any()
                  and torch.equal(xq2, xq) and s_2.item() == s_x.item())
        xq_flat = xq if cq == cin else int8.quantize_kernel(x)[0]
        got = int8.conv_kernel(xq, s_x, wq, stride, pad)
        ref = int8.plain_int8_conv(xq_ref, s_ref, wq.q, wq.scale, stride,
                                   pad, 1, bf16)
        fused, amax = int8.conv_kernel(xq, s_x, wq, stride, pad, 1, bf16,
                                       aff, True, want_amax=True)
        fused_ref = int8.plain_int8_convbn(xq_ref, s_ref, wq.q, wq.scale,
                                           stride, pad, 1, bf16, aff, True)
        err = max((got.float() - ref.float()).abs().max().item(),
                  (fused.float() - fused_ref.float()).abs().max().item())
        same = (torch.equal(got, ref) and torch.equal(fused, fused_ref)
                and amax.item() == fused_ref.float().abs().max().item())
        worst["conv"] = max(worst["conv"], err)
        worst["quantize"] = max(worst["quantize"], float(q_err))
        conv = functools.partial(int8.conv_kernel, xq, s_x, wq, stride, pad)
        kern = functools.partial(int8.conv_kernel, xq, s_x, wq, stride, pad,
                                 1, bf16, aff, True, want_amax=True)
        parent_ms, turns = float("nan"), ""
        if parent is not None:
            old = functools.partial(parent_int8_conv, parent, xq_flat, s_x,
                                    wq._replace(kmajor=flat), stride, pad)
            same = same and torch.equal(old(), got)
            conv_ms, parent_ms, turns = in_turns(conv, old, _int8_timer)
            turns = f"; conv alone in turns with the parent: {turns}"
        else:
            conv_ms = _int8_timer(conv)
        ms = _int8_timer(kern)
        ms16, wide = float("nan"), ""
        if cq != cin:
            # knock-out: the stem on the wgmma tile, its codes and weight
            # zero-padded to 16 channels (one 128-channel slice a tap)
            xq16 = torch.zeros((n, h, w, 16), dtype=torch.int8,
                               device="cuda")
            xq16[..., :cq] = xq.permute(0, 2, 3, 1)
            xq16 = xq16.permute(0, 3, 1, 2)
            wq16 = int8.prepare_weight(F.pad(wt, (0, 0, 0, 0, 0, 16 - cin)))
            wide_kern = functools.partial(int8.conv_kernel, xq16, s_x, wq16,
                                          stride, pad, 1, bf16, aff, True,
                                          want_amax=True)
            out16, amax16 = wide_kern()
            same = (same and torch.equal(out16, fused)
                    and amax16.item() == amax.item())
            ms, ms16, _ = in_turns(kern, wide_kern, _int8_timer)
            extra_ms = 1e3 * 12 * n * h * w / HBM_BYTES_PER_S
            wide = (f"; knock-out on the wgmma tile (codes padded to 16 "
                    f"channels, = kernel {torch.equal(out16, fused)}), fused"
                    f", in turns: {ms16:.4f} ms against {ms:.4f} ms, and "
                    f"its codes pass writes 12 more bytes a pixel (+"
                    f"{extra_ms:.4f} ms at the memory rate)")
            del xq16, wq16, out16
        plain_ms = cuda_ms(lambda: int8.plain_int8_convbn(
            xq_flat, s_x, wq.q, wq.scale, stride, pad, 1, bf16, aff, True),
            iters=2, warmup=1)
        a = _im2col(xq_flat, k, stride, pad, flat.shape[1])
        bt = flat.t()
        acc = torch._int_mm(a, bt)
        mm_same = torch.equal(
            (acc.float() * (s_x * wq.scale)).to(bf16),
            got.permute(0, 2, 3, 1).reshape(acc.shape))
        mm_ms = _int8_timer(lambda: torch._int_mm(a, bt))
        del a, acc
        wb = wt.to(bf16).contiguous(memory_format=torch.channels_last)
        sb, bb = (t.to(bf16).view(1, -1, 1, 1) for t in aff)
        dnn_ms = _int8_timer(lambda: F.conv2d(x, wb, stride=stride,
                                              padding=pad))
        dnn_bn_ms = _int8_timer(lambda: F.relu(F.conv2d(
            x, wb, stride=stride, padding=pad) * sb + bb))
        # the quantize passes: amax + codes, and the codes pass alone
        amax_x = int8.plain_amax(x)
        q_full = _int8_timer(lambda: int8.quantize_kernel(x, channels=cq))
        q_codes = _int8_timer(lambda: int8.quantize_kernel(x, amax_x, cq))
        q_parent_ms = float("nan")
        if parent is not None:
            q_old = functools.partial(parent_int8_quantize, parent, x)
            pq, ps = q_old()
            q_same = (q_same and torch.equal(pq, xq_flat)
                      and ps.item() == s_x.item())
            q_full, q_parent_ms, q_turns = in_turns(
                lambda: int8.quantize_kernel(x, channels=cq), q_old,
                _int8_timer)
            turns += f"; amax + codes in turns {q_turns}"
        q_plain = cuda_ms(lambda: int8.plain_quantize_per_tensor(x),
                          iters=3, warmup=1)
        kk = k * k * cin
        m = got.numel() // cout
        # the activation codes the taps cover, at the conv's own Cin (a 1x1
        # stride-2 conv reads a quarter of the pixels)
        act = n * min(h * w, k * k * (m // n)) * cin
        bound, kind = bound_ms(
            counts.int8_conv(n, *got.shape[2:], cin, cout, k, k), torch.int8,
            act + cout * kk + 4 * cout + 4 + 2 * got.numel())
        kinds.add(kind)
        amax_bound = 1e3 * counts.int8_amax_bytes(
            x.numel(), x.element_size()) / HBM_BYTES_PER_S
        codes_bound = 1e3 * counts.int8_codes_bytes(
            x.numel(), x.element_size()) / HBM_BYTES_PER_S
        vals = dict(zip(keys, (ms, conv_ms, plain_ms, bound, mm_ms, dnn_ms,
                               dnn_bn_ms, parent_ms, q_parent_ms,
                               ms if cq != cin else 0.0,
                               ms16 if cq != cin else 0.0)))
        for p, per in shapes.items():
            for key in keys:
                totals[p][key] += per.get(shape, 0) * vals[key]
        # quantize calls of this input shape a request, with and without an
        # epilogue's amax (the parent ran one amax + codes pass a conv),
        # summed at the first conv shape that reads it
        for p, per in (quants.items() if (n, cin, h, w) not in counted
                       else ()):
            with_amax = per.get(((n, cin, h, w), True), 0)
            alone = per.get(((n, cin, h, w), False), 0)
            totals[p]["q_ms"] += with_amax * q_codes + alone * q_full
            totals[p]["q_plain_ms"] += (with_amax + alone) * q_plain
            totals[p]["q_bound_ms"] += (with_amax * codes_bound + alone
                                        * (amax_bound + codes_bound))
        counted.add((n, cin, h, w))
        calls = {p: per.get(shape, 0) for p, per in shapes.items()}
        print(f"int8 {n}x{cin}x{h}x{w} -> {cout}, {k}x{k} s{stride} p{pad} "
              f"(calls a request {calls}) on the {path} tile: codes = plain "
              f"{q_same}, out = plain {same} (conv alone and with BN + ReLU,"
              f" amax; max |diff| {err:.3g}), _int_mm dequantized = kernel "
              f"{mm_same}; fused kernel {ms:.4f} ms, cuDNN bf16 conv + BN + "
              f"ReLU {dnn_bn_ms:.4f} ms; conv alone {conv_ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, _int_mm {mm_ms:.4f} ms, cuDNN bf16 conv "
              f"{dnn_ms:.4f} ms, bound {bound:.4f} ms by {kind} (conv alone "
              f"at {bound / conv_ms:.0%} of it); amax + codes {q_full:.4f} ms"
              f" (bound {amax_bound + codes_bound:.4f}, at "
              f"{(amax_bound + codes_bound) / q_full:.0%}), codes alone "
              f"{q_codes:.4f} ms (bound {codes_bound:.4f}, at "
              f"{codes_bound / q_codes:.0%}), plain {q_plain:.3f} ms{turns}"
              f"{wide}"
              + (" ok" if same and q_same and mm_same else " FAIL"),
              flush=True)
        if not (same and q_same and mm_same):
            raise AssertionError(f"int8 {shape}: the kernels disagree with "
                                 f"their plain versions")
        del x, wt, wq, xq, xq_ref, xq_flat, got, ref, fused, fused_ref, wb
        torch.cuda.empty_cache()
    for p, tot in totals.items():
        print(f"int8 per {p} request ({sum(shapes[p].values())} convs, "
              f"{sum(quants[p].values())} quantizes): fused kernel "
              f"{tot['ms']:.3f} ms, cuDNN bf16 conv + BN + ReLU "
              f"{tot['cudnn_bn_relu_ms']:.3f} ms; conv alone "
              f"{tot['conv_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
              f"_int_mm {tot['int_mm_ms']:.3f} ms, cuDNN bf16 conv "
              f"{tot['cudnn_ms']:.3f} ms (conv alone / cuDNN "
              f"{tot['conv_ms'] / tot['cudnn_ms']:.3f}), bound "
              f"{tot['bound_ms']:.3f} ms ({tot['bound_ms'] / tot['conv_ms']:.0%}"
              f" of the conv alone); quantize {tot['q_ms']:.3f} ms, plain "
              f"{tot['q_plain_ms']:.3f} ms, bound {tot['q_bound_ms']:.3f} ms"
              + (f"; parent conv {tot['parent_ms']:.3f} ms (conv alone / "
                 f"parent {tot['conv_ms'] / tot['parent_ms']:.3f}), parent "
                 f"quantize {tot['q_parent_ms']:.3f} ms over "
                 f"{sum(shapes[p].values())} passes (quantize / parent "
                 f"{tot['q_ms'] / tot['q_parent_ms']:.3f})"
                 if parent is not None else "")
              + f"; the stems {tot['stem_ms']:.4f} ms (knock-out on the wgmma"
              f" tile {tot['stem16_ms']:.4f})" + f" on {smi}", flush=True)
    # a small activation the pass runs 12 times a VoVNet request: host µs a
    # wrapper call against the device ms, and the ms cuda_ms reads there
    # (the events then bracket launches the host is still issuing)
    x = torch.randn(6, 224, 29, 50, device="cuda", generator=g).to(
        bf16).contiguous(memory_format=torch.channels_last)
    quant = functools.partial(int8.quantize_kernel, x)
    amax_x = int8.plain_amax(x)
    print(f"int8 quantize at 6x224x29x50: host {host_us(quant):.1f} µs a "
          f"wrapper call (amax + codes), {host_us(lambda: int8.quantize_kernel(x, amax_x)):.1f} µs "
          f"(codes alone)"
          + (f", parent {host_us(lambda: parent_int8_quantize(parent, x)):.1f}"
             f" µs" if parent is not None else "")
          + f"; device {_int8_timer(quant):.4f} ms queued (queued_ms), "
          f"{cuda_ms(quant, iters=10, warmup=2):.4f} ms by cuda_ms"
          + (f"; parent {_int8_timer(lambda: parent_int8_quantize(parent, x)):.4f}"
             f" / {cuda_ms(lambda: parent_int8_quantize(parent, x), iters=10, warmup=2):.4f} ms"
             if parent is not None else "") + f" on {smi}")
    # the registered ops (the main path's route, eager and exported)
    # against the bare wrappers they dispatch to, at the same activation
    # and its 224 -> 224 3x3 conv with ConvBN's epilogue (12 a VoVNet
    # request), in inference mode as the eval step calls them; the least
    # of three turns, op and wrapper in turns
    wt = torch.randn(224, 224, 3, 3, device="cuda",
                     generator=g) / math.sqrt(9 * 224)
    wq = int8.prepare_weight(wt)
    sc, bi = _affine(g, 224)
    xq, s_x = int8.quantize_kernel(x)
    tr = torch.ops.transcar
    pairs = {
        "amax": (lambda: tr.int8_amax(x), lambda: int8.amax_kernel(x)),
        "codes": (lambda: tr.int8_codes(x, amax_x, 224),
                  lambda: int8.codes_kernel(x, amax_x)),
        "conv": (lambda: tr.int8_conv(xq, s_x, wq.q, wq.scale, wq.kmajor, 1,
                                      1, 1, bf16, sc, bi, True, True),
                 lambda: int8.conv_kernel(xq, s_x, wq, 1, 1, 1, bf16,
                                          (sc, bi), True, True)),
        "conv without amax": (
            lambda: tr.int8_conv(xq, s_x, wq.q, wq.scale, wq.kmajor, 1, 1,
                                 1, bf16, sc, bi, True, False),
            lambda: int8.conv_kernel(xq, s_x, wq, 1, 1, 1, bf16, (sc, bi),
                                     True, False)),
        "ConvBN's call (amax + codes + conv)": (
            lambda: int8.dynamic_int8_conv(
                x, wt, weight_q=wq, stride=1, padding=1,
                out_dtype=bf16, affine=(sc, bi), relu=True),
            lambda: int8.conv_kernel(*int8.quantize_kernel(x), wq, 1, 1, 1,
                                     bf16, (sc, bi), True)),
    }
    parts = []
    with torch.inference_mode():
        for name, (op, bare) in pairs.items():
            turns = [(host_us(op), host_us(bare)) for _ in range(3)]
            a, b = (min(t[i] for t in turns) for i in (0, 1))
            parts.append(f"{name} op {a:.2f}, wrapper {b:.2f} (op dispatch "
                         f"{a - b:+.2f})")
    print("int8 host µs a call at 6x224x29x50 (inference mode): "
          + "; ".join(parts) + f" on {smi}", flush=True)
    print(f"int8 phase: {time.perf_counter() - t0:.1f} s")
    r101 = totals["transcar_r101"]
    note = ("no TPU kernel: the JAX package runs this in XLA, "
            "transcar_tpu/ops/int8.py:48")
    return {
        "int8_conv": {"max_abs_err": worst["conv"], "ms": r101["conv_ms"],
                      "fused_ms": r101["ms"],
                      "plain_ms": r101["plain_ms"],
                      "bound_ms": r101["bound_ms"],
                      "bound_by": ("operations" if "operations" in kinds
                                   else "bytes"),
                      "library_ms": r101["int_mm_ms"],
                      "cudnn_bf16_ms": r101["cudnn_ms"],
                      "cudnn_bn_relu_ms": r101["cudnn_bn_relu_ms"],
                      "parent_ms": (r101["parent_ms"] if parent is not None
                                    else None), "note": note},
        "int8_quantize": {"max_abs_err": worst["quantize"],
                          "ms": r101["q_ms"],
                          "plain_ms": r101["q_plain_ms"],
                          "bound_ms": r101["q_bound_ms"],
                          "bound_by": "bytes", "library_ms": None,
                          "parent_ms": (r101["q_parent_ms"]
                                        if parent is not None else None),
                          "note": note}}


# --- parallelism (phases 23-26) -----------------------------------------------

#: Tolerances of phases 23 and 25: the JAX package's mesh tests
#: (tests/test_lidar_mesh.py) and its dry run (__graft_entry__.py:214-238).
DP_TOL = 1e-4
TP_LOSS_TOL = 1e-4
TP_PARAM_TOL = 1e-3
#: Bars of the summed gradients (before the clip) and their norm, float32
#: (``dryrun.grad_error``: the whole vector's relative error and the
#: worst tensor's), set from this script's readings on the H100 (PERF.md
#: §6): R101 5.4e-5 / 1.4e-4, the pillar 1.4e-3 / 6.2e-3 (its float32
#: gradients move by ~1e-3 when the rounding of a batch of 1 instead of 2
#: moves a sampling point across a cell edge: the one-process float32
#: step is 1.8e-3 from float64 on the CPU, while 2 ranks are 1e-14 from
#: one process there in float64), tensor parallel 1.3e-7 / 9.5e-7.  A
#: wrong sum is off by ~0.5 (the CPU tests' mutations).  One AdamW step
#: moves a weight by about ± lr whatever its gradient, so the parameters
#: above cannot see the gradients.
DP_GRAD_TOL = {"r101": 1e-3, "pillar": 3e-2}
TP_GRAD_TOL = 1e-4
#: One decoder layer for the equality checks: the random-weight decoder
#: amplifies rounding ~10× a layer (phase_slice), and the one-process
#: and per-rank camera trunks convolve batches of 2 and 1.
ONE_LAYER = "model.head.num_decoder_layers=1"


def _parallel_cases() -> dict:
    from transcar_tpu_torch.parallel import dryrun

    full = dict(hw=(928, 1600), max_gt=32)
    return {
        "r101_fp32": dryrun.case("transcar_r101", [
            "model.backbone.compute_dtype=float32", ONE_LAYER], batch=2,
            **full),
        "pillar_fp32": dryrun.case("objdgcnn_pillar", [
            "model.lidar_compute_dtype=float32", ONE_LAYER], batch=2,
            **full),
        "r101_bf16": dryrun.case("transcar_r101", batch=2, dropout=0.1,
                                 **full),
        "pillar_bf16": dryrun.case("objdgcnn_pillar", batch=2, dropout=0.1,
                                   **full),
        "r101_tp": dryrun.case("transcar_r101", [ONE_LAYER], dropout=0.1,
                               **full),
        "r101_eval": dryrun.case("transcar_r101", [ONE_LAYER], **full)}


def phase_parallel(smi: str) -> None:
    """Phases 23 and 25: one group of 2 ranks on the card over gloo runs
    the data-parallel checks and timings, then the tensor-parallel ones;
    the one-process references are taken here first."""
    import tempfile

    from transcar_tpu_torch.parallel import dryrun

    cases = _parallel_cases()
    tmp = tempfile.mkdtemp(prefix="transcar_parallel_")
    refs = {}
    t0 = time.perf_counter()
    for name in ("r101_fp32", "pillar_fp32"):
        refs[name] = os.path.join(tmp, name + ".pt")
        dryrun.save_reference(cases[name], refs[name], torch.device("cuda"))
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = dryrun.spawn(dryrun.run_calls, 2, [
        ("dp_check", (cases["r101_fp32"], refs["r101_fp32"])),
        ("dp_check", (cases["pillar_fp32"], refs["pillar_fp32"])),
        ("dp_time", (cases["r101_bf16"],)),
        ("dp_time", (cases["pillar_bf16"],)),
        ("tp_check", (cases["r101_tp"], 1, 2, cases["r101_eval"]))],
        backend="gloo", device="cuda", threads=3)
    t_ranks = time.perf_counter() - t0
    for f in refs.values():
        os.remove(f)
    os.rmdir(tmp)
    # a rank's step: its DCN or MSDeformAttn launches and one matching
    want = {"r101": {"dcn_forward": 26, "hungarian": 1},
            "pillar": {"hungarian": 1, **{k: 3 for k in (
                "msdeform_forward", "msdeform_backward_taps",
                "msdeform_backward_value")}}}
    want_bf16 = {"r101": want["r101"],
                 "pillar": {k: 8 if k.startswith("msdeform") else v
                            for k, v in want["pillar"].items()}}
    bad = []
    for i, name in enumerate(("r101", "pillar")):
        for rank, res in enumerate(ranks):
            r, t = res[i], res[2 + i]
            ok = (r["loss_rel_err"] <= DP_TOL and r["param_ratio"] <= 1.0
                  and r["buffer_ratio"] <= 1.0 and r["agree"]
                  and max(r["grad_rel_err"], r["grad_worst"],
                          r["norm_rel_err"]) <= DP_GRAD_TOL[name]
                  and all(r["launches"].get(k) == v
                          for k, v in want[name].items())
                  and all(t["launches"].get(k) == v
                          for k, v in want_bf16[name].items())
                  and t["finite"])
            bad += [] if ok else [f"{name} rank {rank}"]
            print(f"data parallel {name} rank {rank} of 2 (gloo, one card): "
                  f"float32 one decoder layer vs one process, global batch "
                  f"2: loss rel err {r['loss_rel_err']:.3e} (tol {DP_TOL}), "
                  f"summed gradients rel err {r['grad_rel_err']:.3e}, worst "
                  f"tensor {r['grad_worst']:.3e}, norm {r['norm_rel_err']:.3e}"
                  f" (tol {DP_GRAD_TOL[name]}), "
                  f"params max |diff| {r['param_abs']:.3e} (ratio to tol "
                  f"{r['param_ratio']:.3f}), BN stats max |diff| "
                  f"{r['buffer_abs']:.3e} (ratio {r['buffer_ratio']:.3f}), "
                  f"ranks bit for bit {r['agree']}, launches {r['launches']} "
                  f"(want {want[name]}); bf16 full depth: {t['ms']:.1f} ms a "
                  f"step a rank, launches a step {t['launches']} (want "
                  f"{want_bf16[name]}), peak {t['peak_gib']:.2f} GiB a rank, "
                  f"gradient all-reduce {t['allreduce_ms']:.1f} ms over "
                  f"{t['grad_mib']:.1f} MiB on {smi}")
    k2_ok = True
    for rank, res in enumerate(ranks):
        r = res[4]
        calls = r["k2_calls"]
        k2_ok &= (r["k2_launches"] == 3 and len(calls) == 3 and all(
            c["shape"] == [1, 4, 900, 32] and c["tokens"] == 1500
            and c["rel_err"] <= ATTN_TOL for c in calls))
        ok = (r["loss_err"] <= TP_LOSS_TOL and r["param_abs"] < TP_PARAM_TOL
              and r["eval_err"] <= SLICE_TOL and r["agree"]
              and max(r["grad_rel_err"], r["grad_worst"],
                      r["norm_rel_err"]) <= TP_GRAD_TOL)
        bad += [] if ok else [f"tensor parallel rank {rank}"]
        k2_errs = "; ".join(
            f"{c['shape']} x {c['tokens']}: max |diff| "
            f"{c['max_abs_err']:.3e}, over max |plain| {c['rel_err']:.3e}"
            for c in calls)
        print(f"tensor parallel rank {rank} of 2 (gloo, one card), "
              f"transcar_r101 one decoder layer: eval forward vs replicated "
              f"max |diff|/(1+|ref|) {r['eval_err']:.3e} (tol {SLICE_TOL}); "
              f"K2 launches {r['k2_launches']} at 4 heads, vs plain "
              f"{k2_errs} (tol {ATTN_TOL} of max |plain|); train step "
              f"(dropout 0.1): loss "
              f"{r['loss']:.6f} vs {r['loss_rep']:.6f}, Δ/(1+|loss|) "
              f"{r['loss_err']:.3e} (tol {TP_LOSS_TOL}), gradients rel err "
              f"{r['grad_rel_err']:.3e}, worst tensor {r['grad_worst']:.3e}, "
              f"norm {r['norm_rel_err']:.3e} (tol {TP_GRAD_TOL}), "
              f"params max |diff| "
              f"{r['param_abs']:.3e} (tol {TP_PARAM_TOL}), {r['split']} "
              f"tensors split")
    print(f"parallel phases: references {t_ref:.1f} s, 2 ranks "
          f"{t_ranks:.1f} s on {smi}")
    if bad or not k2_ok:
        raise AssertionError(f"parallel: {bad}, K2 at 4 heads ok {k2_ok}")


def phase_nccl_world1(smi: str) -> None:
    """Phase 24: a pillar step through the data-parallel code over an
    NCCL group of one rank (a data group that is the world: the gradient
    all-reduce and the loss sums go through NCCL; a BatchNorm sums over a
    group of two or more ranks only), beside two steps with no group.
    Every sum of the step has one order (the kernels' and PyTorch's
    deterministic mode), so the losses, the BatchNorm running statistics,
    the summed gradients and the parameters after the update are held bit
    for bit: the second step with no group to the first, and the NCCL
    step to the first (``dryrun.grad_error`` printed beside)."""
    import torch.distributed as dist

    from transcar_tpu_torch.parallel import dryrun
    from transcar_tpu_torch.parallel.distributed import init_group
    from transcar_tpu_torch.parallel.mesh import Grid

    spec = dryrun.case("objdgcnn_pillar", [
        "model.lidar_compute_dtype=float32", ONE_LAYER], max_gt=32)
    dev = torch.device("cuda")
    init_group(0, 1, "nccl", dryrun.free_address())
    try:
        runs = [dryrun.train_case(spec, dev, grid, keep_grads=True)
                for grid in (None, None, Grid(data_group=dist.group.WORLD))]
    finally:
        dist.destroy_process_group()
    sched = runs[0].state.scheduler
    lr0 = max(sched.base_lrs) * sched.lr_lambdas[0](0)
    ref = runs[0]
    params = dict(ref.state.model.named_parameters())
    stats = {n: b for n, b in ref.state.model.named_buffers()
             if "running" in n}

    def compare(run):
        """(losses and BN statistics bit for bit, the gradients bit for
        bit, the parameters bit for bit, the gradients' grad_error pair,
        max |diff| of the parameters in lr₀)."""
        got = dict(run.state.model.named_parameters())
        forward = run.losses == ref.losses and all(
            torch.equal(b, stats[n])
            for n, b in run.state.model.named_buffers() if n in stats)
        grads = run.grads.keys() == ref.grads.keys() and all(
            torch.equal(run.grads[n], g) for n, g in ref.grads.items())
        same = all(torch.equal(got[n], p) for n, p in params.items())
        worst = max((got[n] - p).abs().max().item()
                    for n, p in params.items())
        return (forward, grads, same, dryrun.grad_error(run.grads, ref.grads),
                worst / lr0)

    repeat, nccl = compare(runs[1]), compare(runs[2])
    print(f"nccl world 1 (objdgcnn_pillar, float32, one decoder layer; losses "
          f"{runs[2].losses[0]['total']:.6f} vs {ref.losses[0]['total']:.6f})"
          f": no group twice: losses and BN statistics / gradients / "
          f"parameters bit for bit {repeat[0]} / {repeat[1]} / {repeat[2]} "
          f"(gradients rel err {repeat[3][0]:.3e}, worst tensor "
          f"{repeat[3][1]:.3e}, params max |diff| {repeat[4]:.3f} lr0); over "
          f"NCCL against no group: {nccl[0]} / {nccl[1]} / {nccl[2]} "
          f"({nccl[3][0]:.3e}, {nccl[3][1]:.3e}, {nccl[4]:.3f} lr0; lr0 "
          f"{lr0:.3e}) on {smi}")
    if not all(repeat[:3] + nccl[:3]):
        raise AssertionError("nccl world 1: a step with no group does not "
                             "repeat itself, or the grouped step differs")


def phase_camera_sharding(smi: str) -> None:
    """Phase 26: the camera-sharded eval forward at full width, in float32
    and in bfloat16, held bit for bit (FPN levels and head outputs) to
    the unsharded forward whose backbone and FPN take as many cameras at
    a time (``dryrun.chunked_features``): cuDNN picks its convolution
    algorithms by batch size, and from ``layer2_0`` on the convolutions
    of one or two images round otherwise than those of six (the stem and
    ``layer1`` agree bit for bit; K1 is as close to its plain version at
    1 and 2 images as at 6).  Against the plain unsharded forward the
    float32 backbone is also held to :data:`SLICE_TOL` (|Δ| / (1 +
    |ref|)); the bfloat16 one's distance, which the random-weight R101
    amplifies, is printed."""
    from transcar_tpu_torch.parallel import dryrun

    base = _parallel_cases()["r101_eval"]
    results = {}
    for dtype in ("float32", "bfloat16"):
        spec = dict(base, options=base["options"] + [
            f"model.backbone.compute_dtype={dtype}"])
        _zero_counts()
        res = results[dtype] = dryrun.camera_check(spec, torch.device("cuda"))
        print(f"camera sharding transcar_r101 {dtype} backbone, one decoder "
              f"layer, the card listed g times: against the unsharded "
              f"forward at g's cameras a conv, FPN levels bit for bit "
              f"{res['same_fpn']}, head outputs bit for bit "
              f"{res['same_equal']}; against the plain unsharded forward, "
              f"FPN levels bit for bit {res['fpn_equal']}, |diff|/(1+|ref|) "
              f"{res['fpn_rel_err']}; head outputs bit for bit "
              f"{res['equal']}, |diff|/(1+|ref|) {res['rel_err']}"
              f"{f' (tol {SLICE_TOL})' if dtype == 'float32' else ''}; K1 "
              f"launches {res['k1']} (want 26 a camera group) on {smi}")
        torch.cuda.empty_cache()
    f32 = results["float32"]
    if (any(r["k1"][g] != 26 * g for r in results.values() for g in r["k1"])
            or not all(v for r in results.values()
                       for v in (*r["same_fpn"].values(),
                                 *r["same_equal"].values()))
            or max(*f32["fpn_rel_err"].values(),
                   *f32["rel_err"].values()) > SLICE_TOL):
        raise AssertionError(f"camera sharding: {results}")


#: Phase 28's serving requests: the six presets and the three opt-in
#: serving configurations, (preset, --cfg-options).
REPEAT_REQUESTS = (
    ("transcar_r101", ()), ("detr3d_r101", ()), ("transcar_r101_cbgs", ()),
    ("transcar_vovnet_trainval", ()), ("objdgcnn_pillar", ()),
    ("objdgcnn_voxel", ()),
    ("transcar_r101", ("model.backbone.quantize=int8",)),
    ("transcar_vovnet_trainval", ("model.backbone.osa_reduce_impl=fused",)),
    ("transcar_r101", ("model.backbone.block_impl=fused",)))
#: Phase 28's train steps: the six presets in their phases' dtypes.
REPEAT_STEPS = ("transcar_r101", "detr3d_r101", "transcar_r101_cbgs",
                "transcar_vovnet_trainval", "objdgcnn_pillar",
                "objdgcnn_voxel")
#: The integer type of each float type's width, to compare bits.
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
         torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _leaves(tree, prefix: str = "") -> list:
    """(name, tensor) of every tensor in a tree of dicts, lists and
    tuples."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [leaf for k, v in items for leaf in _leaves(v, f"{prefix}/{k}")]


def _differing(first, second) -> tuple:
    """(tensors compared, names of those whose bits differ: shape, dtype
    or any bit, NaN payloads included)."""
    a, b = _leaves(first), _leaves(second)
    if [n for n, _ in a] != [n for n, _ in b]:
        return len(a), ["<structure>"]
    bad = []
    for (name, x), (_, y) in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            bad.append(name)
        elif x.dtype in _BITS:
            if not torch.equal(x.contiguous().view(_BITS[x.dtype]),
                               y.contiguous().view(_BITS[y.dtype])):
                bad.append(name)
        elif not torch.equal(x, y):
            bad.append(name)
    return len(a), bad


def _repeat_request(preset: str, options) -> tuple:
    """One serving request of ``preset`` at full width run twice on the
    same model and input: the raw head outputs and the decoded ones."""
    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.eval.decode import nms_free_decode

    args = benchmark.parse_args([preset, "--cfg-options", *options])
    cfg, model, batch, _ = benchmark._setup(args, training=False)
    inputs = ([batch["points"], batch["num_points"]]
              if cfg.model.lidar_encoder else
              [batch["images"], batch["lidar2img"], batch.get("radar_tokens")])
    runs = []
    with torch.inference_mode():
        for _ in range(2):
            raw = model(*inputs)
            runs.append({"raw": raw,
                         "decoded": nms_free_decode(raw, cfg.model.head)})
    torch.cuda.synchronize()
    return _differing(*runs)


def _repeat_step(preset: str) -> tuple:
    """One train step of ``preset`` at full width (``benchmark --train``'s
    model, batch and dtypes) run twice from the same parameters, buffers,
    optimizer and schedule state and the same generator states: the
    losses, every gradient, and every parameter and buffer after it."""
    import copy

    from transcar_tpu_torch.cli import benchmark
    from transcar_tpu_torch.train.step import (apply_gradients, gradients,
                                               init_state)

    args = benchmark.parse_args([preset, "--train"])
    cfg, model, batch, _ = benchmark._setup(args, training=True)
    state = init_state(cfg, model, total_steps=2)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt0 = copy.deepcopy(state.optimizer.state_dict())
    sched0 = copy.deepcopy(state.scheduler.state_dict())
    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        state.optimizer.load_state_dict(opt0)
        state.scheduler.load_state_dict(sched0)
        state.step = 0
        torch.manual_seed(args.seed + 3)                  # dropout
        gen = torch.Generator().manual_seed(args.seed + 2)  # GridMask
        losses = gradients(state, batch, gen)
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        losses = apply_gradients(state, losses)
        runs.append({"losses": losses, "grads": grads,
                     "after": {k: v.detach().clone()
                               for k, v in model.state_dict().items()}})
    torch.cuda.synchronize()
    return _differing(*runs)


def _kernel_repeats() -> None:
    """K3, K4, K5 and K9 launched twice at one of their phase shapes each
    (a ``detr3d_r101`` layer-3 conv at the model's offsets, VoVNet's
    stage-2 block, the pillar encoder's call), for a run of phase 28
    alone; the full run reads the repeats phases 4, 8 and 15 made."""
    from transcar_tpu_torch.ops import (pallas_dcn, pallas_msdeform,
                                        pallas_osa, pallas_osa_block)

    g = torch.Generator(device="cuda").manual_seed(28)
    n, h, w, cin, cout, _ = FLAGSHIP_DCN[0]
    x, om, wt, d_out = dcn_backward_case(g, n, h, w, cin, cout,
                                         torch.bfloat16, "model")
    repeats("K3 bfloat16 layer 3, offsets model",
            pallas_dcn.backward_kernel(x, om, wt, d_out),
            pallas_dcn.backward_kernel(x, om, wt, d_out))
    del x, om, wt, d_out
    h, w, c0, ch, cout, _ = VOV_BLOCKS[0]
    widths = [c0] + [ch] * 5
    pieces = [torch.randn(6, h, w, c, device="cuda", generator=g).bfloat16()
              for c in widths]
    ws = pallas_osa.kmajor_weights(torch.randn(
        cout, sum(widths), device="cuda", generator=g) / math.sqrt(
            sum(widths)), widths, torch.bfloat16)
    aff = _affine(g, cout)
    repeats("K4 bfloat16 stage 2", pallas_osa.osa_reduce(pieces, ws, *aff),
            pallas_osa.osa_reduce(pieces, ws, *aff))
    w9s, affs, c = [], [], c0
    for _ in range(5):
        w9s.append((torch.randn(3, 3, c, ch, device="cuda", generator=g)
                    / math.sqrt(9 * c)).bfloat16())
        affs.append(_affine(g, ch))
        c = ch
    args = (pieces[0], w9s, affs, ws, aff)
    repeats("K5 bfloat16 stage 2", pallas_osa_block.osa_block_fused(*args),
            pallas_osa_block.osa_block_fused(*args))
    del pieces, ws, w9s, args
    s = sum(hl * wl for hl, wl in BEV_LEVELS)
    value, loc, wgt = msdeform_case(g, s, True)
    d_out = torch.randn(1, s, 256, device="cuda", generator=g)
    repeats("K9 encoder", (pallas_msdeform.backward_value_kernel(
        value, BEV_LEVELS, loc, wgt, d_out),), (
        pallas_msdeform.backward_value_kernel(value, BEV_LEVELS, loc, wgt,
                                              d_out),))
    del value, loc, wgt, d_out
    torch.cuda.empty_cache()


def phase_repeat(smi: str) -> None:
    """Phase 28: the port repeats itself bit for bit.  Each serving
    request of :data:`REPEAT_REQUESTS` twice (every raw head output and
    every decoded output), each train step of :data:`REPEAT_STEPS` twice
    from the same state and batch (the losses, every gradient, every
    parameter and buffer after the update), and K3, K4, K5 and K9
    launched twice (:data:`REPEATS`: the phases' launches, or
    :func:`_kernel_repeats` when the phase runs alone); every comparison
    of bits, NaN payloads included."""
    if not any(k.startswith("K9") for k in REPEATS):
        _kernel_repeats()
    failed = [k for k, same in REPEATS.items() if not same]
    kinds = sorted({k.split()[0] for k in REPEATS})
    print(f"repeat kernels: {len(REPEATS)} launches twice ({', '.join(kinds)}"
          f"), bit for bit {len(REPEATS) - len(failed)} of {len(REPEATS)}"
          + (f"; differing {failed}" if failed else ""), flush=True)
    bad = list(failed)
    for preset, options in REPEAT_REQUESTS:
        t0 = time.perf_counter()
        count, diff = _repeat_request(preset, options)
        name = " ".join((preset, *options))
        print(f"repeat request {name}: {count} outputs, bit for bit "
              f"{count - len(diff)} of {count}"
              + (f"; differing {diff[:8]}" if diff else "")
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        bad += [f"{name}{d}" for d in diff]
        torch.cuda.empty_cache()
    for preset in REPEAT_STEPS:
        t0 = time.perf_counter()
        count, diff = _repeat_step(preset)
        print(f"repeat train step {preset}: {count} losses, gradients, "
              f"parameters and buffers, bit for bit {count - len(diff)} of "
              f"{count}" + (f"; differing {diff[:8]}" if diff else "")
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        bad += [f"{preset} step{d}" for d in diff]
        torch.cuda.empty_cache()
    print(f"repeat: everything bit for bit {not bad} on {smi}", flush=True)
    if bad:
        raise AssertionError(f"repeat: {len(bad)} results differ between "
                             f"two runs: {bad[:12]}")


def _timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a line with its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
                         "variants of the K1, K2, K5, K6, K7, K8, K9 or int8 "
                         "kernels (VARIANTS), then exit")
    ap.add_argument("--repeat", action="store_true",
                    help="instead of the phases: phase 28 alone (every "
                         "serving configuration and train step, and K3, K4, "
                         "K5 and K9, run twice and compared bit for bit), "
                         "then exit")
    ap.add_argument("--export-child", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # PyTorch's deterministic mode, as every entry point of the port sets
    # it, before anything touches the card (phase 28 reads its effect)
    from transcar_tpu_torch.core.device import set_deterministic
    set_deterministic("cuda")
    if args.export_child:           # one process of phase_tools
        export_child(*args.export_child[:3], args.export_child[3:])
        return
    smi = phase_device()
    if args.variants:
        phase_variants(VARIANT_KINDS if args.variants == "all"
                       else [args.variants], smi)
        return
    phase_build()
    if args.repeat:
        phase_repeat(smi)
        return
    parent = parent_library(args.parent_csrc) if args.parent_csrc else None
    k1 = _timed(phase_k1, parent)
    k3 = _timed(phase_k3, parent)
    k2 = _timed(phase_k2, parent)
    launches = _timed(phase_slice, smi)
    train = _timed(phase_train, smi)
    _timed(phase_train_check)
    launches["dcn_backward"] = train["detr3d_r101"]["launches"][1]
    k4 = _timed(phase_k4, parent)
    k5 = _timed(phase_k5, parent)
    k6 = _timed(phase_k6, parent)
    launches["osa_reduce"] = _timed(phase_vovnet_slice, smi)["osa_reduce"]
    launches["osa_block"] = _timed(phase_k5_path, smi)
    launches["bottleneck"] = _timed(phase_k6_path, smi)
    _timed(phase_vovnet_train, smi)
    k7 = _timed(phase_k7, parent)
    launches["msdeform_forward"] = _timed(phase_lidar, smi, "objdgcnn_pillar")
    k8, k9 = _timed(phase_k8_k9, parent)
    train_launches = _timed(phase_lidar_train, smi, "objdgcnn_pillar")
    _timed(phase_lidar_train_check, "objdgcnn_pillar")
    _timed(phase_lidar, smi, "objdgcnn_voxel")
    _timed(phase_lidar_train, smi, "objdgcnn_voxel")
    _timed(phase_lidar_train_check, "objdgcnn_voxel")
    _timed(phase_sync)
    _timed(phase_step_sync)
    phase_pipeline(smi, then=lambda tmp, data: phase_tools(tmp, data,
                                                           smi))
    int8_launches, int8_shapes, int8_quants = _timed(phase_int8_slices, smi)
    int8_res = _timed(phase_int8, int8_shapes, int8_quants, smi, parent)
    _timed(phase_parallel, smi)
    _timed(phase_nccl_world1, smi)
    _timed(phase_camera_sharding, smi)
    k_hungarian = _timed(phase_hungarian, smi)
    _timed(phase_repeat, smi)
    launches["hungarian"] = train["detr3d_r101"]["launches"][3]
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
             "transcar_tpu/ops/pallas_msdeform.py:592"),
            ("hungarian", k_hungarian, "transcar_tpu_torch/csrc/hungarian.cu",
             "transcar_tpu/ops/hungarian.py:33")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"],
                        "bound_ms": res["bound_ms"],
                        "bound_by": res["bound_by"],
                        "library_ms": res["library_ms"],
                        "parent_ms": res.get("parent_ms"),
                        **{k: res[k] for k in ("host_ms", "scans",
                                               "scans_longest") if k in res}})
    # the int8 conv's launches on the wgmma tile, and the quantize passes'
    # standalone amax launches (a codes pass without a producer's amax)
    extra = {"int8_conv": {"wgmma_launches": int8_launches["int8_wgmma"]},
             "int8_quantize": {"amax_launches": int8_launches["int8_amax"]}}
    for name, res in int8_res.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "transcar_tpu_torch/csrc/int8_conv.cu",
                        "replaces": None, "launches": int8_launches[name],
                        **extra[name], **res})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
