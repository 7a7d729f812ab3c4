"""2D annotation export (coco-style json) from a nuScenes infos pkl
(``transcar_tpu/data/export2d.py``).

The reference data converter's ``export_2d_annotation`` /
``get_2d_boxes`` / ``post_process_coords`` / ``generate_record``
(``tools/data_converter/nuscenes_converter.py:348-638``), emitted by its
data-prep CLI (``tools/create_data.py:70-80``, here ``cli/create_data.py
--with-2d-anno``).  No training pipeline reads it.

As in the JAX package:
  * pure numpy: shapely's convex hull and intersection are a monotone-chain
    hull and a Sutherland–Hodgman clip to the canvas (the same min/max box,
    since the canvas is axis-aligned);
  * the nuScenes handle is duck-typed (``get`` / ``box_velocity``), so the
    export runs without the devkit in the tests; real runs pass a
    ``nuscenes.NuScenes``;
  * image sizes are read from disk when the JPEG exists, else the nuScenes
    camera canvas (1600, 900) is assumed.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

from transcar_tpu_torch.core.config import CLASS_NAMES
from transcar_tpu_torch.data.infos import NAME_MAPPING

CAM_TYPES = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
             "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")

# nuscenes_converter.py:20-24
NUS_ATTRIBUTES = ("cycle.with_rider", "cycle.without_rider",
                  "pedestrian.moving", "pedestrian.standing",
                  "pedestrian.sitting_lying_down", "vehicle.moving",
                  "vehicle.parked", "vehicle.stopped", "None")


# ---------------------------------------------------------------------------
# quaternion + box geometry (numpy; wxyz convention like pyquaternion)
# ---------------------------------------------------------------------------

def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_inv(q):
    q = np.asarray(q, np.float64)
    return np.array([q[0], -q[1], -q[2], -q[3]]) / np.dot(q, q)


def quat_rot_mat(q):
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_yaw(q):
    """First Euler angle (yaw) of a wxyz quaternion — matches
    ``Quaternion.yaw_pitch_roll[0]``."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return float(np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))


class Box3D:
    """Minimal nuScenes-devkit ``Box`` analog: global-frame center/size/
    orientation with translate/rotate (devkit Box semantics)."""

    def __init__(self, center, wlh, quat_wxyz, token=None):
        self.center = np.asarray(center, np.float64).copy()
        self.wlh = np.asarray(wlh, np.float64).copy()
        self.quat = np.asarray(quat_wxyz, np.float64).copy()
        self.token = token

    def translate(self, t):
        self.center = self.center + np.asarray(t, np.float64)

    def rotate(self, quat_wxyz):
        r = quat_rot_mat(quat_wxyz)
        self.center = r @ self.center
        self.quat = quat_mul(quat_wxyz, self.quat)

    def corners(self) -> np.ndarray:
        """[3, 8] corners, devkit ordering (x fwd ±l/2, y left ±w/2,
        z up ±h/2; first four at +z)."""
        w, l, h = self.wlh
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
        return quat_rot_mat(self.quat) @ np.vstack([x, y, z]) \
            + self.center[:, None]


def view_points(points: np.ndarray, intrinsic: np.ndarray,
                normalize: bool) -> np.ndarray:
    """Devkit ``view_points``: [3, N] → [3, N] after K and optional
    perspective divide."""
    view = np.eye(3)
    view[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
    pts = view @ points
    if normalize:
        pts = pts / pts[2:3]
    return pts


def points_cam2img(points: np.ndarray, intrinsic: np.ndarray,
                   with_depth: bool = False) -> np.ndarray:
    """mmdet3d ``points_cam2img``: [N, 3] cam points → [N, 2(+1)]."""
    uv = view_points(np.asarray(points, np.float64).T, intrinsic, True)
    out = uv[:2].T
    if with_depth:
        out = np.concatenate([out, np.asarray(points)[:, 2:3]], axis=1)
    return out


# ---------------------------------------------------------------------------
# convex hull ∩ canvas (shapely replacement)
# ---------------------------------------------------------------------------

def _cross2(u, v) -> float:
    return float(u[0] * v[1] - u[1] * v[0])


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; returns hull vertices CCW."""
    pts = np.unique(np.asarray(pts, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and _cross2(out[-1] - out[-2],
                                            p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _clip_poly_rect(poly: np.ndarray, xmax: float, ymax: float
                    ) -> np.ndarray:
    """Sutherland–Hodgman clip of a polygon to [0,xmax]×[0,ymax]."""
    def clip_edge(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            ia, ib = inside(a), inside(b)
            if ia:
                out.append(a)
                if not ib:
                    out.append(intersect(a, b))
            elif ib:
                out.append(intersect(a, b))
        return np.array(out) if out else np.zeros((0, 2))

    def x_cross(a, b, x):
        t = (x - a[0]) / (b[0] - a[0])
        return np.array([x, a[1] + t * (b[1] - a[1])])

    def y_cross(a, b, y):
        t = (y - a[1]) / (b[1] - a[1])
        return np.array([a[0] + t * (b[0] - a[0]), y])

    for inside, inter in (
            (lambda p: p[0] >= 0, lambda a, b: x_cross(a, b, 0.0)),
            (lambda p: p[0] <= xmax, lambda a, b: x_cross(a, b, xmax)),
            (lambda p: p[1] >= 0, lambda a, b: y_cross(a, b, 0.0)),
            (lambda p: p[1] <= ymax, lambda a, b: y_cross(a, b, ymax))):
        if len(poly) == 0:
            return poly
        poly = clip_edge(poly, inside, inter)
    return poly


def post_process_coords(
        corner_coords: List, imsize: Tuple[int, int] = (1600, 900)
) -> Optional[Tuple[float, float, float, float]]:
    """Bounding box of hull(corners) ∩ image canvas, or None
    (nuscenes_converter.py:544-575).  Degenerate (zero-area) overlaps
    return None like shapely's empty ``exterior``."""
    hull = _convex_hull(np.asarray(corner_coords, np.float64))
    if len(hull) < 3:
        # degenerate (collinear) projection: keep in-canvas points only
        inside = [p for p in np.asarray(corner_coords, np.float64)
                  if 0 <= p[0] <= imsize[0] and 0 <= p[1] <= imsize[1]]
        if not inside:
            return None
        arr = np.array(inside)
        return (float(arr[:, 0].min()), float(arr[:, 1].min()),
                float(arr[:, 0].max()), float(arr[:, 1].max()))
    poly = _clip_poly_rect(hull, float(imsize[0]), float(imsize[1]))
    if len(poly) == 0:
        return None
    return (float(poly[:, 0].min()), float(poly[:, 1].min()),
            float(poly[:, 0].max()), float(poly[:, 1].max()))


# ---------------------------------------------------------------------------
# record generation + per-camera box walk
# ---------------------------------------------------------------------------

def generate_record(ann_rec: dict, x1, y1, x2, y2, sample_data_token: str,
                    filename: str) -> Optional[dict]:
    """coco-style record (nuscenes_converter.py:577-638)."""
    cat = ann_rec.get("category_name")
    if cat not in NAME_MAPPING:
        return None
    cat_name = NAME_MAPPING[cat]
    return {
        "file_name": filename,
        "image_id": sample_data_token,
        "area": (y2 - y1) * (x2 - x1),
        "category_name": cat_name,
        "category_id": CLASS_NAMES.index(cat_name),
        "bbox": [x1, y1, x2 - x1, y2 - y1],
        "iscrowd": 0,
    }


def get_2d_boxes(nusc, sample_data_token: str, visibilities: List[str],
                 mono3d: bool = True) -> List[dict]:
    """2D records for one camera keyframe (nuscenes_converter.py:412-541).

    ``nusc`` is duck-typed: needs ``get(table, token)`` for sample_data /
    sample / calibrated_sensor / ego_pose / sample_annotation / attribute,
    and ``box_velocity(ann_token)``.
    """
    sd_rec = nusc.get("sample_data", sample_data_token)
    s_rec = nusc.get("sample", sd_rec["sample_token"])
    cs_rec = nusc.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    pose_rec = nusc.get("ego_pose", sd_rec["ego_pose_token"])
    intrinsic = np.array(cs_rec["camera_intrinsic"], np.float64)

    recs = []
    for token in s_rec["anns"]:
        ann = nusc.get("sample_annotation", token)
        if ann["visibility_token"] not in visibilities:
            continue
        box = Box3D(ann["translation"], ann["size"], ann["rotation"],
                    token=token)
        # global → ego → camera
        box.translate(-np.asarray(pose_rec["translation"]))
        box.rotate(quat_inv(pose_rec["rotation"]))
        box.translate(-np.asarray(cs_rec["translation"]))
        box.rotate(quat_inv(cs_rec["rotation"]))

        corners_3d = box.corners()
        in_front = corners_3d[2, :] > 0
        if not in_front.any():
            continue
        corners_3d = corners_3d[:, in_front]
        corner_coords = view_points(corners_3d, intrinsic, True).T[:, :2]
        final = post_process_coords(corner_coords.tolist())
        if final is None:
            continue
        min_x, min_y, max_x, max_y = final
        rec = generate_record(ann, min_x, min_y, max_x, max_y,
                              sample_data_token, sd_rec["filename"])
        if rec is None:
            continue
        if mono3d:
            loc = box.center.tolist()
            w, l, h = box.wlh
            dim = [l, h, w]          # wlh → mmdet3d cam lhw (:505-507)
            rot = [-quat_yaw(box.quat)]
            velo2d = np.asarray(nusc.box_velocity(token), np.float64)[:2]
            velo3d = np.array([velo2d[0], velo2d[1], 0.0])
            e2g_r = quat_rot_mat(pose_rec["rotation"])
            c2e_r = quat_rot_mat(cs_rec["rotation"])
            cam_velo = velo3d @ np.linalg.inv(e2g_r).T \
                @ np.linalg.inv(c2e_r).T
            rec["bbox_cam3d"] = loc + dim + rot
            rec["velo_cam3d"] = cam_velo[0::2].tolist()
            center2d = points_cam2img(np.array(loc)[None], intrinsic,
                                      with_depth=True)
            rec["center2d"] = center2d.squeeze().tolist()
            if rec["center2d"][2] <= 0:       # behind camera: drop (:530)
                continue
            attrs = ann.get("attribute_tokens", [])
            attr_name = (nusc.get("attribute", attrs[0])["name"] if attrs
                         else "None")
            rec["attribute_name"] = attr_name
            rec["attribute_id"] = NUS_ATTRIBUTES.index(attr_name)
        recs.append(rec)
    return recs


def export_2d_annotation(nusc, info_path: str, mono3d: bool = True,
                         out_path: Optional[str] = None) -> dict:
    """Walk the infos pkl and dump ``<info_path[:-4]>[_mono3d].coco.json``
    (nuscenes_converter.py:348-410).  Returns the coco dict."""
    with open(info_path, "rb") as f:
        nusc_infos = pickle.load(f)["infos"]
    cat2id = [{"id": i, "name": n} for i, n in enumerate(CLASS_NAMES)]
    coco = {"annotations": [], "images": [], "categories": cat2id}
    ann_id = 0
    for info in nusc_infos:
        for cam in CAM_TYPES:
            cam_info = info["cams"][cam]
            token = cam_info["sample_data_token"]
            recs = get_2d_boxes(nusc, token,
                                visibilities=["", "1", "2", "3", "4"],
                                mono3d=mono3d)
            width, height = _image_size(cam_info["data_path"])
            coco["images"].append({
                "file_name": cam_info["data_path"].split(
                    "data/nuscenes/")[-1],
                "id": token,
                "token": info["token"],
                "cam2ego_rotation": list(cam_info["sensor2ego_rotation"]),
                "cam2ego_translation": list(
                    cam_info["sensor2ego_translation"]),
                "ego2global_rotation": list(info["ego2global_rotation"]),
                "ego2global_translation": list(
                    info["ego2global_translation"]),
                "cam_intrinsic": np.asarray(
                    cam_info["cam_intrinsic"]).tolist(),
                "width": width,
                "height": height,
            })
            for rec in recs:
                rec["segmentation"] = []
                rec["id"] = ann_id
                coco["annotations"].append(rec)
                ann_id += 1
    if out_path is None:
        suffix = "_mono3d" if mono3d else ""
        out_path = f"{info_path[:-4]}{suffix}.coco.json"
    with open(out_path, "w") as f:
        json.dump(coco, f)
    print(f"wrote {len(coco['annotations'])} 2d annos to {out_path}")
    return coco


def _image_size(path: str) -> Tuple[int, int]:
    if os.path.exists(path):
        try:
            from PIL import Image
            with Image.open(path) as im:
                return im.size
        except Exception:
            pass
    return 1600, 900   # nuScenes camera canvas
