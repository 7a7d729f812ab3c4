"""Typed configuration: the port's own copy of the JAX package's
``transcar_tpu/core/config.py`` (its dataclasses, the six presets and the
dotted ``--cfg-options`` overrides), plus ``parse_overrides`` from
``transcar_tpu/cli/train.py``.

The port never imports or loads a file of ``transcar_tpu`` (importing
``transcar_tpu.core.config`` would run ``transcar_tpu/core/__init__.py``,
which imports ``jax.numpy``), so it keeps this copy.  Field names,
defaults and override semantics are the JAX package's;
``tests/test_torch_config.py`` holds every preset equal, field by field,
to the JAX ``get_preset``, so a drift between the two copies fails a test.
The comments below are the JAX package's: TPU-only knobs are accepted by
the port as no-ops (``models/detector.py::build_model``), the kernel
knobs ``dcn_impl``, ``osa_reduce_impl`` and ``block_impl`` resolve in
``models/detector.py`` (``resolve_*``), and ``remat="auto"`` resolves to
off (``models/detector.py::resolve_remat``).

Presets (reference config file → preset name):
  detr3d_res101_gridmask.py                      → "transcar_r101"
  detr3d_res101_gridmask.py w/o fusion           → "detr3d_r101" (camera-only)
  detr3d_res101_gridmask_cbgs.py                 → "transcar_r101_cbgs"
  detr3d_vovnet_gridmask_det_final_trainval_cbgs → "transcar_vovnet_trainval"
  obj_dgcnn voxel/pillar                         → "objdgcnn_pillar"
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)

CLASS_NAMES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)


@dataclass(frozen=True)
class BackboneConfig:
    """Image backbone (ResNet-101-caffe-DCN / VoVNet-99) + FPN.

    Parity: configs/detr3d/detr3d_res101_gridmask.py:32-50 and
    detr3d_vovnet_gridmask_det_final_trainval_cbgs.py:32-46.
    """
    kind: str = "resnet101"          # "resnet101" | "resnet50" | "vovnet99"
    frozen_stages: int = 1           # caffe-style stage freezing
    norm_eval: bool = True           # BN frozen (folded scale/bias)
    with_dcn: Tuple[bool, ...] = (False, False, True, True)
    fpn_in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    fpn_out_channels: int = 256
    fpn_start_level: int = 1
    fpn_num_outs: int = 4
    fpn_add_extra_convs: str = "on_output"
    fpn_relu_before_extra_convs: bool = True
    compute_dtype: Optional[str] = "bfloat16"   # backbone compute dtype
                                     # (the @auto_fp16 analog, detr3d.py:68);
                                     # None = inherit input dtype
    head_input_dtype: str = "float32"   # dtype the FPN feature maps are
                                     # STORED in for the head's sampling
                                     # gathers ("float32" = reference
                                     # parity; "bfloat16" halves the
                                     # dominant HBM streams — sampled
                                     # features are cast back to fp32
                                     # before any decoder math,
                                     # ops/sampling.py)
    dcn_impl: str = "auto"           # "auto" | "exact" | "pallas": DCNv2
                                     # path.  "auto" → the fused Pallas
                                     # kernel (fwd + custom-VJP bwd,
                                     # ops/pallas_dcn.py) on TPU for both
                                     # training and inference; the exact
                                     # XLA gather on CPU meshes
    dcn_band_rows: int = 14          # pallas row band: exact for vertical
                                     # offsets |Δy| ≤ (band−4)/2 px (= 5);
                                     # widen for checkpoints with larger
                                     # learned offsets
    dcn_variant: str = "banded"      # pallas forward formulation:
                                     # "banded" (one-hot dot + VPU
                                     # y-blend) | "onedot" (y folded into
                                     # the one-hot, single dot).  Same
                                     # band semantics; measured tie on
                                     # v5e (docs/PERF_NOTES.md)
    quantize: str = "none"           # "none" | "int8": dynamic int8
                                     # backbone convs at INFERENCE
                                     # (ops/int8.py; per-channel weight +
                                     # per-tensor activation scales on
                                     # the 2x-peak MXU int8 path).
                                     # Opt-in accuracy-for-speed serving
                                     # mode — never a parity path, forced
                                     # off in training by build_model
    block_impl: str = "auto"         # ResNet stride-1 non-DCN blocks:
                                     # "auto" | "xla" | "fused" (one
                                     # Pallas kernel per bottleneck,
                                     # ops/pallas_bottleneck.py).  "auto"
                                     # → xla everywhere: the kernel
                                     # measured NEGATIVE at model level
                                     # (8.05 → 7.48 sps); opt-in only
    stem_impl: str = "auto"          # backbone stem: "auto" | "xla" |
                                     # "phase" (ops/phase_stem.py: same
                                     # params, conv math on the stride-4
                                     # phase grid).  "auto" → xla
                                     # everywhere: phase wins in
                                     # isolation but loses at model
                                     # level (docs/PERF_NOTES.md
                                     # "context beats isolation")
    osa_reduce_impl: str = "auto"    # VoVNet OSA tail: "auto" | "xla" |
                                     # "pallas".  "auto" → the fused
                                     # concat-reduce kernel
                                     # (ops/pallas_osa.py) on TPU at
                                     # inference; XLA for training/CPU
                                     # (kernel is forward-only)
    dcn_rows_per_step: int = 1       # pallas grid coarsening: output rows
                                     # per grid step (amortizes the ~10 µs
                                     # per-step floor, docs/PERF_NOTES.md).
                                     # Each row keeps its own band slice,
                                     # so exactness is rows-independent
                                     # and the knob applies to training
                                     # and inference alike
    remat: str = "auto"              # backbone-block rematerialization:
                                     # "auto" → on only when a camera
                                     # backward exists (full-backbone
                                     # training; HBM for recompute) —
                                     # its checkpoint boundaries cost
                                     # ~20 ms/sample of layout copies,
                                     # so inference/frozen-camera skip
                                     # it.  "on"/"off" force either way
                                     # (e.g. "off" trades HBM for a
                                     # faster full-train backward)


@dataclass(frozen=True)
class HeadConfig:
    """DETR3D decoder + TransCAR fusion head.

    Parity: configs/detr3d/detr3d_res101_gridmask.py:51-102 plus the
    hard-coded fusion hyperparameters inside detr3d_head.py.
    """
    num_query: int = 900
    num_classes: int = 10
    embed_dims: int = 256
    num_decoder_layers: int = 6
    num_heads: int = 8
    ffn_dims: int = 512
    num_levels: int = 4
    num_cams: int = 6
    num_points: int = 1              # sampling points per query (config :76)
    num_reg_fcs: int = 2
    code_size: int = 10
    code_weights: Tuple[float, ...] = (
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
    with_box_refine: bool = True
    pc_range: Tuple[float, ...] = PC_RANGE
    # --- TransCAR fusion (detr3d_head.py:74-195,538-729) ---
    with_radar_fusion: bool = True
    num_fusion_layers: int = 3
    num_radar_tokens: int = 1500     # fixed token buffer (:526)
    radar_feat_dim: int = 36         # 36-dim radar feature (:498-510)
    radar_pad_value: float = 500.0   # padding sentinel fills all dims (:527)
    # per-fusion-layer attention-circle radius clamps (:567,:635,:693)
    fusion_radius_clamps: Tuple[Tuple[float, float], ...] = (
        (1.0, 2.0), (1.0, 2.0), (0.5, 1.0))
    # --- losses (config :95-102) ---
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 0.25
    bg_cls_weight: float = 0.0
    sync_cls_avg_factor: bool = True
    # --- matcher (config :104-114) ---
    match_cls_weight: float = 2.0
    match_reg_weight: float = 0.25
    # --- decode (config :83-89) ---
    max_detections: int = 300
    post_center_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    score_threshold: Optional[float] = None
    # replicate reference numerical quirks bit-for-bit (SURVEY.md §7 item 4)
    strict_reference_compat: bool = True
    # fused Pallas masked attention for the fusion layers (TPU inference
    # path; XLA serves autodiff/CPU either way)
    use_pallas_attention: bool = True


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    use_grid_mask: bool = True       # detr3d.py:36 (prob .7, ratio .5, mode 1)
    # --- LiDAR track (ObjDGCNN): set lidar_encoder to select the model ---
    lidar_encoder: Optional[str] = None     # None | "pillar" | "voxel"
    lidar_compute_dtype: Optional[str] = "bfloat16"   # SECOND+FPN BEV
                                     # conv compute dtype (the camera
                                     # track's bf16 policy applied to the
                                     # LiDAR backbone; BN params/stats
                                     # stay fp32, the head runs fp32).
                                     # None = fp32 everywhere
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 8.0)
    max_voxels: int = 30000                  # pillar.py:32 (train)
    max_points_per_voxel: int = 20
    bev_hw: Tuple[int, int] = (512, 512)
    sparse_shape: Tuple[int, int, int] = (41, 1024, 1024)  # voxel.py:34-43
    # voxel middle-encoder formulation: "gather" (static site buffers +
    # dense-table neighbor lookup — the full-resolution default: XLA
    # pads the dense grid 3.1× at stage-0 shapes, a 24.5 GB HBM OOM) |
    # "dense" (masked MXU convs, exact spconv site sets — small grids)
    sparse_impl: str = "gather"
    # vertical band (rows) for the banded Pallas BEV-encoder deformable
    # attention (ops/pallas_msdeform.py).  0 = auto: 24 on the TPU
    # pallas path — the ObjDGCNN recipe trains the encoder in every
    # preset (no freeze list, unlike the camera trunk), so the band is
    # config-keyed like the camera DCN band and MUST NOT differ between
    # a config's train and eval forwards (trained offsets legitimately
    # reach taps a narrower eval band would silently zero)
    encoder_band_rows: int = 0


@dataclass(frozen=True)
class DataConfig:
    """Dataset & input pipeline.

    Radar featurization runs here (SURVEY.md §7 inversion #1), not inside the
    model forward (reference does per-step file IO, detr3d_head.py:301-536).
    """
    data_root: str = "data/nuscenes"
    version: str = "v1.0-trainval"
    ann_train: str = "nuscenes_infos_train.pkl"
    ann_val: str = "nuscenes_infos_val.pkl"
    class_names: Tuple[str, ...] = CLASS_NAMES
    img_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)  # BGR caffe
    img_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    to_rgb: bool = False
    pad_divisor: int = 32
    img_hw: Tuple[int, int] = (928, 1600)   # 900×1600 padded to ÷32
    normalize_on_device: bool = True  # ship uint8 over host→device (4×
                                      # fewer bytes) and normalize inside
                                      # the jitted step; bit-exact for
                                      # eval.  Training photometric
                                      # distortion also runs ON DEVICE
                                      # (host draws the random choices,
                                      # the pixel math fuses into the
                                      # normalize — the host numpy aug
                                      # chain measured ~5 s/sample and
                                      # serializes loader threads via
                                      # the GIL; see data/loader)
    radar_sweeps: int = 5
    use_cbgs: bool = False
    # static GT padding for jit (SURVEY §7.3); the on-device Hungarian
    # solve scales ~quadratically in this, and range-filtered nuScenes
    # samples stay under ~120 boxes
    max_gt_boxes: int = 128
    photometric_distortion: bool = True
    workers: int = 4
    samples_per_device: int = 1
    # --- LiDAR point pipeline (ObjDGCNN track; pillar.py:174-216) ---
    lidar_load_dim: int = 5            # nuScenes .bin: x,y,z,intensity,ring
    lidar_sweeps: int = 9              # LoadPointsFromMultiSweeps sweeps_num
    lidar_pad_empty_sweeps: bool = True
    lidar_remove_close: float = 1.0    # remove_close radius (0 disables)
    # static point budget for jit ([max_points, 5] + count); 10 frames of
    # nuScenes lidar ≈ 300k points before range filtering
    max_points: int = 300_000
    rot_range: Tuple[float, float] = (-0.3925, 0.3925)
    scale_range: Tuple[float, float] = (0.95, 1.05)
    trans_std: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    flip_ratio_horizontal: float = 0.5
    flip_ratio_vertical: float = 0.5
    point_shuffle: bool = True


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + cosine schedule + freeze mask.

    Parity: config :206-222 and the TransCAR hard freeze
    (tools/train.py:238-252 — only rf_*/final_*/radar_* params train).
    """
    lr: float = 1.5e-5
    backbone_lr_mult: float = 0.1
    weight_decay: float = 0.01
    grad_clip_norm: float = 35.0
    warmup_iters: int = 4000
    warmup_ratio: float = 1.0 / 3.0
    min_lr_ratio: float = 1e-3
    total_epochs: int = 24
    freeze_camera_branch: bool = True   # TransCAR trains only fusion layers


@dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = field(default_factory=OptimConfig)
    seed: int = 0
    eval_interval_epochs: int = 2
    checkpoint_interval_epochs: int = 1
    work_dir: str = "work_dirs/default"
    mesh_shape: Tuple[int, ...] = (8,)       # data-parallel over ICI
    mesh_axis_names: Tuple[str, ...] = ("data",)
    load_from: Optional[str] = None
    resume_from: Optional[str] = None


@dataclass(frozen=True)
class TransCARConfig:
    name: str = "transcar_r101"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

def _detr3d_r101() -> TransCARConfig:
    return TransCARConfig(
        name="detr3d_r101",
        model=ModelConfig(head=HeadConfig(with_radar_fusion=False)),
    )


def _transcar_r101() -> TransCARConfig:
    return TransCARConfig(name="transcar_r101")


def _transcar_r101_cbgs() -> TransCARConfig:
    # detr3d_res101_gridmask_cbgs.py:203-236 — CBGS resampling, lr 2e-4,
    # warmup 500, 6 epochs.
    return TransCARConfig(
        name="transcar_r101_cbgs",
        data=DataConfig(use_cbgs=True),
        train=TrainConfig(
            optim=OptimConfig(lr=2e-4, warmup_iters=500, total_epochs=6)),
    )


def _transcar_vovnet_trainval() -> TransCARConfig:
    # detr3d_vovnet_gridmask_det_final_trainval_cbgs.py:14-46,214
    return TransCARConfig(
        name="transcar_vovnet_trainval",
        model=ModelConfig(
            backbone=BackboneConfig(
                kind="vovnet99",
                with_dcn=(False, False, False, False),
                fpn_in_channels=(256, 512, 768, 1024),
                fpn_start_level=0,
            )),
        data=DataConfig(
            use_cbgs=True,
            img_std=(57.375, 57.120, 58.395),
            to_rgb=False,
            ann_val="nuscenes_infos_test.pkl",
        ),
    )


def _objdgcnn_data() -> DataConfig:
    # pillar.py:258-279: CBGS, samples_per_gpu 3, 9-sweep points
    return DataConfig(use_cbgs=True, samples_per_device=3)


def _objdgcnn_optim() -> OptimConfig:
    # pillar.py:283-293: AdamW 1e-4, wd 0.01, clip 35, 20 epochs, VFE +
    # SECOND at lr×0.1 (the "backbone" group here covers vfe+backbone).
    # The reference's cyclic-20e schedule is replaced by the same
    # warmup+cosine family as the camera track (documented divergence).
    return OptimConfig(lr=1e-4, backbone_lr_mult=0.1, total_epochs=20,
                       warmup_iters=1000, freeze_camera_branch=False)


def _objdgcnn_pillar() -> TransCARConfig:
    # configs/obj_dgcnn/pillar.py — PillarFeatureNet(0.2 m) + scatter +
    # SECOND + BNFPN + DGCNN3DHead.
    return TransCARConfig(
        name="objdgcnn_pillar",
        model=ModelConfig(
            backbone=BackboneConfig(kind="second", norm_eval=False),
            head=HeadConfig(num_query=300, with_radar_fusion=False),
            use_grid_mask=False,
            lidar_encoder="pillar",
        ),
        data=_objdgcnn_data(),
        train=TrainConfig(optim=_objdgcnn_optim()),
    )


def _objdgcnn_voxel() -> TransCARConfig:
    # configs/obj_dgcnn/voxel.py — 0.1 m hard voxelization + sparse 3D
    # encoder variant (models.dgcnn.ObjDGCNN with encoder='voxel').
    return TransCARConfig(
        name="objdgcnn_voxel",
        model=ModelConfig(
            backbone=BackboneConfig(kind="second", norm_eval=False),
            head=HeadConfig(num_query=300, with_radar_fusion=False),
            use_grid_mask=False,
            lidar_encoder="voxel",
            voxel_size=(0.1, 0.1, 0.2),
            max_voxels=90000,
        ),
        data=_objdgcnn_data(),
        train=TrainConfig(optim=_objdgcnn_optim()),
    )


_PRESETS = {
    "detr3d_r101": _detr3d_r101,
    "transcar_r101": _transcar_r101,
    "transcar_r101_cbgs": _transcar_r101_cbgs,
    "transcar_vovnet_trainval": _transcar_vovnet_trainval,
    "objdgcnn_pillar": _objdgcnn_pillar,
    "objdgcnn_voxel": _objdgcnn_voxel,
}


def list_presets():
    return sorted(_PRESETS)


def get_preset(name: str, overrides: Optional[Dict[str, Any]] = None
               ) -> TransCARConfig:
    """Build a preset config, optionally deep-overriding dotted keys,
    e.g. ``get_preset('transcar_r101', {'train.optim.lr': 1e-4})``.

    This is the ``--cfg-options`` analog (tools/train.py:59-68).
    """
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; choose from {list_presets()}")
    cfg = _PRESETS[name]()
    if overrides:
        for key, value in overrides.items():
            cfg = _apply_override(cfg, key.split("."), value)
    return cfg


def _apply_override(obj, path, value):
    if len(path) == 1:
        fld = {f.name: f for f in dataclasses.fields(obj)}[path[0]]
        if isinstance(value, str) and fld.type not in ("str", "Optional[str]"):
            value = _parse_literal(value)
        if isinstance(value, list):
            value = tuple(value)
        return dataclasses.replace(obj, **{path[0]: value})
    child = getattr(obj, path[0])
    return dataclasses.replace(
        obj, **{path[0]: _apply_override(child, path[1:], value)})


def _parse_literal(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def config_to_dict(cfg) -> Dict[str, Any]:
    """Serializable manifest for dump-on-run reproducibility (the reference
    dumps its config into work_dir, tools/train.py:165)."""
    return dataclasses.asdict(cfg)


def parse_overrides(pairs):
    """``["a.b=v", ...]`` → ``{"a.b": "v"}`` (``transcar_tpu/cli/train.py``);
    :func:`get_preset` parses each value against its field's type."""
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[k] = v
    return out
