"""nuScenes infos-pkl dataset: indexing, geometry, GT prep, CBGS.

Consumes the same ``nuscenes_infos_{train,val,test}.pkl`` files the
reference builds (tools/data_converter/nuscenes_converter.py:95-100; the
rebuild's generator lives in the JAX package's cli/create_data.py) so
existing prepared datasets drop in unchanged.  The port's copy of
``transcar_tpu/data/infos.py``.

Re-provided upstream behaviors (SURVEY.md §2.6):
  * lidar2img assembly (CustomNuScenesDataset.get_data_info,
    datasets/nuscenes_dataset.py:46-70) via core.geometry.build_lidar2img.
  * ``use_valid_flag`` GT filtering + class mapping (NuScenesDataset).
  * pkl boxes have center-z origin (0.5, 0.5, 0.5); mmdet3d converts to
    bottom-z LiDAR boxes — both forms exposed here.
  * ObjectRangeFilter (BEV range + limit_yaw to [-π, π)) and
    ObjectNameFilter (config :161-162).
  * CBGS class-balanced resampling (CBGSDataset, cbgs config :203-216).
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from transcar_tpu_torch.core.config import CLASS_NAMES, PC_RANGE
from transcar_tpu_torch.core.geometry import build_lidar2img

CAM_ORDER = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)

# nuScenes detection-name mapping (mmdet3d NuScenesDataset.NameMapping)
NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


@dataclass
class Sample:
    token: str
    timestamp: float
    img_paths: List[str]
    lidar2img: np.ndarray            # [N_cams, 4, 4]
    gt_boxes: np.ndarray             # [G, 9] bottom-z (x,y,z,w,l,h,yaw,vx,vy)
    gt_labels: np.ndarray            # [G] int
    gt_names: List[str]


class NuScenesInfos:
    """Reader over a nuscenes_infos pkl."""

    def __init__(self, ann_file: str, class_names=CLASS_NAMES,
                 use_valid_flag: bool = True, pc_range=PC_RANGE,
                 test_mode: bool = False, data_root: Optional[str] = None):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        self.infos = sorted(infos, key=lambda i: i["timestamp"])
        self.metadata = data.get("metadata", {}) if isinstance(data, dict) \
            else {}
        self.class_names = list(class_names)
        self.use_valid_flag = use_valid_flag
        self.pc_range = pc_range
        self.test_mode = test_mode
        self.data_root = data_root

    def __len__(self):
        return len(self.infos)

    def get_sample(self, idx: int, with_ann: bool = True) -> Sample:
        info = self.infos[idx]
        cams = info["cams"]
        names = [c for c in CAM_ORDER if c in cams] or list(cams)
        rots = np.stack([cams[c]["sensor2lidar_rotation"] for c in names])
        trans = np.stack([cams[c]["sensor2lidar_translation"] for c in names])
        intr = np.stack([cams[c]["cam_intrinsic"] for c in names])
        l2i = build_lidar2img(rots, trans, intr).astype(np.float32)
        paths = [str(cams[c]["data_path"]) for c in names]
        if self.data_root:
            paths = [self._rebase(p) for p in paths]

        gt_boxes = np.zeros((0, 9), np.float32)
        gt_labels = np.zeros((0,), np.int32)
        gt_names: List[str] = []
        if with_ann and not self.test_mode and "gt_boxes" in info:
            gt_boxes, gt_labels, gt_names = self._annotations(info)

        return Sample(info["token"], info["timestamp"], paths, l2i,
                      gt_boxes, gt_labels, gt_names)

    def get_lidar_sample(self, idx: int):
        """LiDAR-track access: the raw info entry (lidar_path, sweeps,
        timestamp — data/points.py consumes it) plus name-filtered GT
        WITHOUT the BEV range filter, which the reference applies after
        augmentation (pillar.py:199-200 ObjectRangeFilter ordering)."""
        info = self.infos[idx]
        gt_boxes = np.zeros((0, 9), np.float32)
        gt_labels = np.zeros((0,), np.int32)
        if not self.test_mode and "gt_boxes" in info:
            gt_boxes, gt_labels, _ = self._annotations(info,
                                                       range_filter=False)
        return info, gt_boxes, gt_labels

    def _rebase(self, path: str) -> str:
        """Remap absolute paths baked into the infos pkl onto data_root
        (the pkl may come from a different machine).  Paths that already
        resolve are kept as-is."""
        import os
        if os.path.exists(path):
            return path
        marker = "nuscenes/"
        i = path.find(marker)
        rel = path[i + len(marker):] if i >= 0 else os.path.basename(path)
        return os.path.join(self.data_root, rel)

    def _annotations(self, info, range_filter: bool = True):
        boxes7 = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)
        vel = np.asarray(info.get("gt_velocity",
                                  np.zeros((len(boxes7), 2))), np.float32)
        vel = np.nan_to_num(vel)
        names = list(info["gt_names"])
        mask = np.ones(len(boxes7), bool)
        if self.use_valid_flag and "valid_flag" in info:
            mask &= np.asarray(info["valid_flag"], bool)
        # name filter (ObjectNameFilter)
        name_idx = np.array(
            [self.class_names.index(NAME_MAPPING.get(n, n))
             if NAME_MAPPING.get(n, n) in self.class_names else -1
             for n in names], np.int32)
        mask &= name_idx >= 0
        boxes7, vel, name_idx = boxes7[mask], vel[mask], name_idx[mask]
        names = [n for n, m in zip(names, mask) if m]

        # pkl origin (.5,.5,.5) → bottom-z (mmdet3d convert_to)
        boxes7 = boxes7.copy()
        boxes7[:, 2] -= boxes7[:, 5] * 0.5
        boxes9 = np.concatenate([boxes7, vel], axis=1)

        if range_filter:
            # ObjectRangeFilter: BEV center range + limit_yaw (config :161)
            bev = np.asarray(
                [self.pc_range[0], self.pc_range[1],
                 self.pc_range[3], self.pc_range[4]])
            keep = ((boxes9[:, 0] > bev[0]) & (boxes9[:, 0] < bev[2])
                    & (boxes9[:, 1] > bev[1]) & (boxes9[:, 1] < bev[3]))
            boxes9, name_idx = boxes9[keep], name_idx[keep]
            names = [n for n, m in zip(names, keep) if m]
            # limit_yaw(offset=0.5, period=2π) → yaw ∈ [-π, π)
            boxes9[:, 6] = (boxes9[:, 6] + np.pi) % (2 * np.pi) - np.pi
        return boxes9, name_idx, names


def cbgs_indices(dataset: NuScenesInfos,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Class-balanced resampling (CBGSDataset semantics): duplicate sample
    indices so every class's share of samples is ~1/num_classes."""
    rng = rng or np.random.default_rng(0)
    ncls = len(dataset.class_names)
    cls_samples: Dict[int, List[int]] = {c: [] for c in range(ncls)}
    for i in range(len(dataset)):
        s = dataset.get_sample(i)
        for c in np.unique(s.gt_labels):
            cls_samples[int(c)].append(i)
    total = sum(len(v) for v in cls_samples.values())
    if total == 0:
        return np.arange(len(dataset))
    frac = 1.0 / ncls
    out: List[int] = []
    for c, idxs in cls_samples.items():
        if not idxs:
            continue
        ratio = frac / (len(idxs) / total)
        reps = int(len(idxs) * ratio)
        out.extend(rng.choice(idxs, reps, replace=True).tolist())
    return np.asarray(out, np.int64)
