"""nuScenes submission formatting + devkit evaluation wrapper.

Re-provides the upstream ``NuScenesDataset.format_results`` / ``evaluate``
behaviors the reference relies on (SURVEY.md §2.6; tools/test.py:226-242):

  * lidar-frame detections → global frame via the sample's lidar2ego and
    ego2global poses (mmdet3d ``lidar_nusc_box_to_global``),
  * the mmdet3d-0.17-era box convention used by DETR3D checkpoints:
    internal dims are already NuScenesBox (w, l, h) order and pass
    through unchanged; yaw maps ``-yaw - π/2`` (output_to_nusc_box),
  * class-range filtering from the detection config,
  * attribute assignment by speed (NuScenesDataset._format_bbox),
  * devkit ``DetectionEval`` → mAP/NDS when nuscenes-devkit + raw data are
    available (eval stays host-side, same as the reference).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}

# nuScenes detection eval class ranges (detection_cvpr_2019)
CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """[w, x, y, z] quaternion → 3×3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def yaw_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return [
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ]


def detections_to_nusc_annos(
    boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
    valid: np.ndarray, info: Dict, class_names,
) -> List[Dict]:
    """One sample's decoded detections → list of nuScenes result dicts.

    boxes: [K, 9] bottom-z lidar boxes (x, y, z, w, l, h, yaw, vx, vy).
    info: the sample's infos-pkl entry (lidar2ego_*, ego2global_* poses).
    """
    l2e_r = quat_to_rot(np.asarray(info["lidar2ego_rotation"]))
    l2e_t = np.asarray(info["lidar2ego_translation"])
    e2g_r = quat_to_rot(np.asarray(info["ego2global_rotation"]))
    e2g_t = np.asarray(info["ego2global_translation"])
    l2e_q = list(np.asarray(info["lidar2ego_rotation"], np.float64))
    e2g_q = list(np.asarray(info["ego2global_rotation"], np.float64))

    annos = []
    for k in range(len(boxes)):
        if not valid[k]:
            continue
        x, y, z, w, l, h, yaw, vx, vy = [float(v) for v in boxes[k]]
        name = class_names[int(labels[k])]
        # gravity center for NuScenesBox
        center = np.array([x, y, z + h / 2.0])
        # mmdet3d-0.17 convention (output_to_nusc_box): internal dims are
        # already nuScenes (w, l, h) — the pkl stores ``b.wlh`` unreordered
        # and the head's circle offsets treat index 4 as length-along-
        # heading (detr3d_head.py:554-559 via tmp[...,3].exp()) — so dims
        # pass through unchanged; nusc yaw = -yaw - π/2.  (The
        # ``dims[[1,0,2]]`` reorder is mmdet3d-1.x, whose *internal*
        # order is (l, w, h) — applying it here swapped w/l.)
        wlh = [w, l, h]
        nyaw = -yaw - np.pi / 2.0
        vel = np.array([vx, vy, 0.0])

        # lidar → ego → global (lidar_nusc_box_to_global)
        center = l2e_r @ center + l2e_t
        vel_g = l2e_r @ vel
        q = _quat_mul(l2e_q, yaw_quat(nyaw))
        # class-range filter on the ego-frame *gravity-center* radius —
        # mmdet3d filters between the lidar2ego and ego2global steps
        # (lidar_nusc_box_to_global; devkit re-filters on eval too)
        if np.linalg.norm(center[:2]) > CLASS_RANGE.get(name, 50):
            continue
        center = e2g_r @ center + e2g_t
        vel_g = e2g_r @ vel_g
        q = _quat_mul(e2g_q, q)

        speed = float(np.hypot(vx, vy))
        if speed > 0.2:
            if name in ("car", "construction_vehicle", "bus", "truck",
                        "trailer"):
                attr = "vehicle.moving"
            elif name in ("bicycle", "motorcycle"):
                attr = "cycle.with_rider"
            else:
                attr = DEFAULT_ATTRIBUTES[name]
        elif name == "pedestrian":
            attr = "pedestrian.standing"
        elif name == "bus":
            attr = "vehicle.stopped"
        else:
            attr = DEFAULT_ATTRIBUTES[name]

        annos.append({
            "sample_token": info["token"],
            "translation": [float(v) for v in center],
            "size": wlh,
            "rotation": [float(v) for v in q],
            "velocity": [float(vel_g[0]), float(vel_g[1])],
            "detection_name": name,
            "detection_score": float(scores[k]),
            "attribute_name": attr,
        })
    return annos


def write_submission(results: Dict[str, List[Dict]], out_path: str,
                     modality: Optional[Dict] = None) -> str:
    """Dump the nuScenes submission json (format_results analog)."""
    sub = {
        "meta": modality or {
            "use_camera": True, "use_lidar": False, "use_radar": True,
            "use_map": False, "use_external": False,
        },
        "results": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(sub, f)
    return out_path


def evaluate_nuscenes(result_path: str, data_root: str,
                      version: str = "v1.0-trainval",
                      eval_set: str = "val") -> Dict[str, float]:
    """Devkit DetectionEval → metric dict (tools/test.py:233-242 analog).
    Requires nuscenes-devkit and the raw dataset."""
    from nuscenes import NuScenes
    from nuscenes.eval.detection.config import config_factory
    from nuscenes.eval.detection.evaluate import NuScenesEval

    nusc = NuScenes(version=version, dataroot=data_root, verbose=False)
    cfg = config_factory("detection_cvpr_2019")
    out_dir = os.path.join(os.path.dirname(result_path), "eval")
    ev = NuScenesEval(nusc, config=cfg, result_path=result_path,
                      eval_set=eval_set, output_dir=out_dir, verbose=False)
    ev.main(render_curves=False)
    with open(os.path.join(out_dir, "metrics_summary.json")) as f:
        metrics = json.load(f)
    return {
        "mAP": metrics["mean_ap"],
        "NDS": metrics["nd_score"],
        "mATE": metrics["tp_errors"]["trans_err"],
        "mASE": metrics["tp_errors"]["scale_err"],
        "mAOE": metrics["tp_errors"]["orient_err"],
        "mAVE": metrics["tp_errors"]["vel_err"],
        "mAAE": metrics["tp_errors"]["attr_err"],
    }
