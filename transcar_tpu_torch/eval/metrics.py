"""Native nuScenes detection-metric evaluation (mAP / TP errors / NDS).

The reference delegates metric computation to the nuscenes-devkit
(``tools/test.py:233-242`` → ``NuScenesEval`` over a submission json,
config ``detection_cvpr_2019``).  The devkit needs the raw dataset on
disk; this module re-derives the same metric pipeline from the infos pkl
alone, so ``--eval`` works anywhere the framework runs — devkit-free
containers, CI, TPU pods.  Semantics match the published metric
definition (nuScenes CVPR 2019 paper §3.1; devkit
``eval/detection/{algo,data_classes}.py`` behavior, re-derived — no
devkit code is imported or copied):

  * class-range filtering on ego-frame XY distance, removal of GT boxes
    with zero lidar+radar points, and the bike-rack filter (bicycle /
    motorcycle boxes whose center lies inside a ``bicycle_rack``
    annotation box are dropped from GT and predictions alike) — the
    rack boxes come from the infos pkl itself: the converter keeps
    every sample annotation and unmappable category names pass through
    raw, so no devkit, map table, or raw dataset is needed,
  * per-class greedy matching of globally score-sorted predictions to
    the nearest unmatched same-class GT by 2D center distance, at
    thresholds 0.5 / 1 / 2 / 4 m,
  * 101-point recall-interpolated PR curve; AP = mean precision above
    recall 0.1 after subtracting precision 0.1, normalized by 0.9,
  * TP errors (ATE/ASE/AOE/AVE/AAE) accumulated per match at the 2 m
    threshold as cumulative means, interpolated onto the confidence
    curve, averaged from recall 0.1 to the max achieved recall,
  * class exclusions (traffic_cone: AOE/AVE/AAE; barrier: AVE/AAE) and
    NDS = (5·mAP + Σ_tp max(0, 1 − err)) / 10.

GT comes from the same infos-pkl entries the dataset reader consumes
(``cli/create_data.py`` schema, identical to the reference converter's
``tools/data_converter/nuscenes_converter.py:95-100``): lidar-frame
boxes with the mmdet3d ``-yaw − π/2`` convention are lifted to the
global frame through the sample's lidar2ego / ego2global poses — the
same transform chain the submission side uses
(``eval/submission.py::detections_to_nusc_annos``), so GT and
predictions meet in one frame.  GT attributes are read from an optional
``gt_attrs`` info key (written by ``cli/create_data.py`` when the raw
annotations are available); absent attributes behave like the devkit's
empty-attribute annotations (AAE error curve of ones → score 0).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from transcar_tpu_torch.eval.submission import (
    CLASS_RANGE, _quat_mul, quat_to_rot, yaw_quat)

# detection_cvpr_2019 constants (devkit configs/detection_cvpr_2019.json)
DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MEAN_AP_WEIGHT = 5
NELEM = 101
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err",
              "attr_err")
DETECTION_NAMES = (
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier")
# devkit: per-class TP metrics that are undefined and reported as NaN
TP_EXCLUDE = {
    "traffic_cone": ("orient_err", "vel_err", "attr_err"),
    "barrier": ("vel_err", "attr_err"),
}


def quaternion_yaw(q: Sequence[float]) -> float:
    """Yaw of a [w,x,y,z] quaternion: heading of the rotated x-axis
    projected onto the xy-plane (devkit ``quaternion_yaw``)."""
    v = quat_to_rot(np.asarray(q, np.float64)) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def _angle_diff(a: float, b: float, period: float) -> float:
    d = (a - b + period / 2.0) % period - period / 2.0
    return abs(d)


def _scale_iou(size_a: np.ndarray, size_b: np.ndarray) -> float:
    """3D IoU of two boxes aligned at the same center and yaw."""
    sa = np.maximum(np.asarray(size_a, np.float64), 0.0)
    sb = np.maximum(np.asarray(size_b, np.float64), 0.0)
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa)) + float(np.prod(sb)) - inter
    return inter / union if union > 0 else 0.0


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs; all-NaN input → ones (devkit
    ``cummean`` — makes missing attributes cost the full AAE error)."""
    x = np.asarray(x, np.float64)
    valid = ~np.isnan(x)
    if not valid.any():
        return np.ones(len(x))
    csum = np.nancumsum(x)
    cnt = np.cumsum(valid).astype(np.float64)
    return np.divide(csum, cnt, out=np.zeros_like(csum), where=cnt != 0)


def _box_to_global(info: Dict, loc, size_wlh, pkl_yaw, vel_xy,
                   ) -> Tuple[np.ndarray, float, np.ndarray, float]:
    """One lidar-frame pkl GT row → (global gravity-center translation,
    global yaw, global xy velocity, ego XY distance).

    pkl convention (cli/create_data.py:126-140, mirroring the reference
    converter): loc = gravity center, size = nuScenes wlh, stored yaw =
    −yaw_lidar − π/2, velocity in the lidar frame.
    """
    l2e_q = list(np.asarray(info["lidar2ego_rotation"], np.float64))
    e2g_q = list(np.asarray(info["ego2global_rotation"], np.float64))
    l2e_r, l2e_t = quat_to_rot(np.asarray(l2e_q)), np.asarray(
        info["lidar2ego_translation"], np.float64)
    e2g_r, e2g_t = quat_to_rot(np.asarray(e2g_q)), np.asarray(
        info["ego2global_translation"], np.float64)

    center = e2g_r @ (l2e_r @ np.asarray(loc, np.float64) + l2e_t) + e2g_t
    nusc_yaw_lidar = -float(pkl_yaw) - np.pi / 2.0
    q = _quat_mul(e2g_q, _quat_mul(l2e_q, yaw_quat(nusc_yaw_lidar)))
    vel = e2g_r @ (l2e_r @ np.array([vel_xy[0], vel_xy[1], 0.0]))
    ego_dist = float(np.linalg.norm(center[:2] - e2g_t[:2]))
    return center, quaternion_yaw(q), vel[:2], ego_dist


def gt_from_infos(infos: Sequence[Dict]) -> Dict[str, List[Dict]]:
    """Infos-pkl entries → global-frame GT boxes per sample token
    (devkit ``load_gt`` analog).  No pipeline filters are applied here —
    range / zero-point filtering happens in :func:`filter_eval_boxes`,
    exactly where the devkit does it."""
    gts: Dict[str, List[Dict]] = {}
    for info in infos:
        boxes = np.asarray(info.get("gt_boxes",
                                    np.zeros((0, 7))), np.float64)
        boxes = boxes.reshape(-1, 7)
        names = list(info.get("gt_names", []))
        # NaN velocities (single-frame objects) stay NaN: they flow into
        # vel_err and the NaN-aware _cummean excludes those matches from
        # AVE, matching the devkit.  (The training reader data/infos.py
        # zeroes them instead, mirroring mmdet3d — different consumers.)
        vel = np.asarray(info.get("gt_velocity",
                                  np.zeros((len(boxes), 2))), np.float64)
        nl = np.asarray(info.get("num_lidar_pts",
                                 -np.ones(len(boxes))), np.int64)
        nr = np.asarray(info.get("num_radar_pts",
                                 np.zeros(len(boxes))), np.int64)
        attrs = list(info.get("gt_attrs", [""] * len(boxes)))
        from transcar_tpu_torch.data.infos import NAME_MAPPING
        out: List[Dict] = []
        for j in range(len(boxes)):
            # raw-category → detection-name mapping (idempotent when the
            # converter already mapped); unmappable classes are skipped,
            # same as devkit load_gt
            name = NAME_MAPPING.get(names[j], names[j])
            if name not in DETECTION_NAMES:
                continue
            center, yaw, v2, ego_dist = _box_to_global(
                info, boxes[j, :3], boxes[j, 3:6], boxes[j, 6], vel[j])
            out.append({
                "translation": center, "size": boxes[j, 3:6].copy(),
                "yaw": yaw, "velocity": v2, "detection_name": name,
                "attribute_name": attrs[j],
                "num_pts": int(nl[j] + nr[j]) if nl[j] >= 0 else -1,
                "ego_dist": ego_dist,
            })
        gts[info["token"]] = out
    return gts


def preds_from_results(results: Dict[str, List[Dict]],
                       infos: Sequence[Dict]) -> Dict[str, List[Dict]]:
    """Submission-format results → eval boxes (devkit ``load_prediction``
    analog).  ``infos`` supplies each sample's ego pose for the range
    filter; tokens absent from the submission evaluate as empty."""
    ego_t = {i["token"]: np.asarray(i["ego2global_translation"],
                                    np.float64) for i in infos}
    preds: Dict[str, List[Dict]] = {t: [] for t in ego_t}
    for token, dets in results.items():
        if token not in ego_t:
            continue
        for d in dets:
            # skip classes outside the metric definition (a configurable
            # cfg.data.class_names may emit non-standard names); the
            # devkit raises on them, we drop like the GT side does
            if d["detection_name"] not in DETECTION_NAMES:
                continue
            tr = np.asarray(d["translation"], np.float64)
            preds[token].append({
                "translation": tr,
                "size": np.asarray(d["size"], np.float64),
                "yaw": quaternion_yaw(d["rotation"]),
                "velocity": np.asarray(d["velocity"], np.float64),
                "detection_name": d["detection_name"],
                "detection_score": float(d["detection_score"]),
                "attribute_name": d.get("attribute_name", ""),
                "num_pts": -1,
                "ego_dist": float(
                    np.linalg.norm(tr[:2] - ego_t[token][:2])),
            })
    return preds


def _center_in_box(p: np.ndarray, translation: np.ndarray,
                   size_wlh: np.ndarray, yaw: float) -> bool:
    """Devkit ``points_in_box`` for a single point: local coordinates
    along the box axes within the (inclusive) extents.  nuScenes wlh:
    width spans the local y axis, length the local x axis."""
    c, s = np.cos(yaw), np.sin(yaw)
    d = np.asarray(p, np.float64) - np.asarray(translation, np.float64)
    lx = c * d[0] + s * d[1]
    ly = -s * d[0] + c * d[1]
    w, l, h = (float(size_wlh[0]), float(size_wlh[1]),
               float(size_wlh[2]))
    return (abs(lx) <= l / 2.0 and abs(ly) <= w / 2.0
            and abs(float(d[2])) <= h / 2.0)


def bikerack_boxes_from_infos(infos: Sequence[Dict],
                              ) -> Dict[str, List[Dict]]:
    """Global-frame ``static_object.bicycle_rack`` boxes per sample
    token, for :func:`filter_eval_boxes` (devkit
    ``eval/detection/loaders.py filter_eval_boxes`` builds the same
    boxes from ``nusc.get('sample_annotation', ...)``; here they ride
    the infos pkl — the converter stores EVERY sample annotation and
    leaves unmappable category names raw, cli/create_data.py:135-139).
    One knowing approximation: the pkl keeps yaw only, the devkit the
    full annotation quaternion — nuScenes boxes carry no pitch/roll, so
    the center-in-box test is unchanged."""
    racks: Dict[str, List[Dict]] = {}
    for info in infos:
        names = list(info.get("gt_names", []))
        rows = [j for j, n in enumerate(names)
                if n == "static_object.bicycle_rack"]
        if not rows:
            continue
        boxes = np.asarray(info["gt_boxes"], np.float64).reshape(-1, 7)
        out = []
        for j in rows:
            center, yaw, _, _ = _box_to_global(
                info, boxes[j, :3], boxes[j, 3:6], boxes[j, 6],
                (0.0, 0.0))
            out.append({"translation": center,
                        "size": boxes[j, 3:6].copy(), "yaw": yaw})
        racks[info["token"]] = out
    return racks


def filter_eval_boxes(boxes: Dict[str, List[Dict]],
                      class_range: Dict[str, float] = CLASS_RANGE,
                      bikeracks: Optional[Dict[str, List[Dict]]] = None,
                      ) -> Dict[str, List[Dict]]:
    """Class-range + zero-point + bike-rack filtering, in the devkit's
    order (``filter_eval_boxes``: distance, then zero points, then
    bicycle/motorcycle boxes whose center sits inside a bicycle_rack
    annotation box — applied to predictions and GT alike)."""
    out = {}
    for token, bl in boxes.items():
        kept = [b for b in bl
                if b["ego_dist"] < class_range[b["detection_name"]]
                and b["num_pts"] != 0]
        racks = (bikeracks or {}).get(token)
        if racks:
            kept = [b for b in kept
                    if b["detection_name"] not in ("bicycle", "motorcycle")
                    or not any(_center_in_box(b["translation"],
                                              r["translation"], r["size"],
                                              r["yaw"]) for r in racks)]
        out[token] = kept
    return out


def _no_predictions() -> Dict[str, np.ndarray]:
    md = {"recall": np.linspace(0, 1, NELEM),
          "precision": np.zeros(NELEM), "confidence": np.zeros(NELEM)}
    for m in TP_METRICS:
        md[m] = np.ones(NELEM)
    return md


def accumulate(gts: Dict[str, List[Dict]], preds: Dict[str, List[Dict]],
               class_name: str, dist_th: float) -> Dict[str, np.ndarray]:
    """One (class, distance-threshold) PR + TP-error curve set (devkit
    ``algo.accumulate`` analog)."""
    npos = sum(1 for bl in gts.values() for b in bl
               if b["detection_name"] == class_name)
    flat = [(b, token) for token, bl in preds.items() for b in bl
            if b["detection_name"] == class_name]
    if npos == 0 or not flat:
        return _no_predictions()
    # devkit sort: ascending (score, index) reversed — ties break by
    # DESCENDING construction index, not stable order
    flat = [e for _, _, e in sorted(
        ((e[0]["detection_score"], i, e) for i, e in enumerate(flat)),
        key=lambda t: (t[0], t[1]), reverse=True)]

    period = np.pi if class_name == "barrier" else 2 * np.pi
    taken = set()
    tp, fp = [], []
    match = {m: [] for m in TP_METRICS}
    match["conf"] = []
    for pred, token in flat:
        best_dist, best_idx = np.inf, None
        for gi, gt in enumerate(gts[token]):
            if gt["detection_name"] != class_name or (token, gi) in taken:
                continue
            d = float(np.linalg.norm(
                pred["translation"][:2] - gt["translation"][:2]))
            if d < best_dist:
                best_dist, best_idx = d, gi
        if best_dist < dist_th:
            taken.add((token, best_idx))
            tp.append(1)
            fp.append(0)
            gt = gts[token][best_idx]
            match["trans_err"].append(best_dist)
            match["scale_err"].append(
                1.0 - _scale_iou(gt["size"], pred["size"]))
            match["orient_err"].append(
                _angle_diff(gt["yaw"], pred["yaw"], period))
            match["vel_err"].append(float(np.linalg.norm(
                gt["velocity"] - pred["velocity"])))
            match["attr_err"].append(
                np.nan if gt["attribute_name"] == "" else
                1.0 - float(gt["attribute_name"]
                            == pred["attribute_name"]))
            match["conf"].append(pred["detection_score"])
        else:
            tp.append(0)
            fp.append(1)

    # zero matches → the devkit's no_predictions() early return (its
    # confidence curve must be all-zero, not the interp of raw FP
    # confidences; caught by tests/test_metrics_oracle.py)
    if not match["conf"]:
        return _no_predictions()

    tp_c = np.cumsum(tp).astype(np.float64)
    fp_c = np.cumsum(fp).astype(np.float64)
    conf_raw = np.array([e[0]["detection_score"] for e in flat])
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / float(npos)
    rec_interp = np.linspace(0, 1, NELEM)
    md = {"recall": rec_interp,
          "precision": np.interp(rec_interp, rec, prec, right=0),
          "confidence": np.interp(rec_interp, rec, conf_raw, right=0)}
    # per-match cumulative-mean error, mapped onto the confidence
    # axis of the interpolated PR curve (devkit match_data interp)
    mc = np.array(match["conf"])
    for m in TP_METRICS:
        tmp = _cummean(np.array(match[m], np.float64))
        md[m] = np.interp(md["confidence"][::-1], mc[::-1],
                          tmp[::-1])[::-1]
    return md


def calc_ap(md: Dict[str, np.ndarray],
            min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    """Normalized AP over the high-recall/high-precision region."""
    prec = md["precision"].copy()[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def _max_recall_ind(md: Dict[str, np.ndarray]) -> int:
    nz = np.nonzero(md["confidence"])[0]
    return int(nz[-1]) if len(nz) else -1


def calc_tp(md: Dict[str, np.ndarray], metric: str,
            min_recall: float = MIN_RECALL) -> float:
    """Mean TP error between min recall and the max achieved recall;
    1.0 (worst) when the class never reaches min recall."""
    first = round(100 * min_recall) + 1
    last = _max_recall_ind(md)
    if last < first:
        return 1.0
    return float(np.mean(md[metric][first:last + 1]))


def evaluate_detections(results: Dict[str, List[Dict]],
                        infos: Sequence[Dict],
                        class_names: Sequence[str] = DETECTION_NAMES,
                        class_range: Dict[str, float] = CLASS_RANGE,
                        dist_ths: Sequence[float] = DIST_THS,
                        ) -> Dict[str, object]:
    """Full detection eval → devkit-shaped metrics summary dict."""
    racks = bikerack_boxes_from_infos(infos)
    gts = filter_eval_boxes(gt_from_infos(infos), class_range, racks)
    preds = filter_eval_boxes(preds_from_results(results, infos),
                              class_range, racks)

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tp: Dict[str, Dict[str, float]] = {}
    for cls in class_names:
        mds = {th: accumulate(gts, preds, cls, th) for th in dist_ths}
        label_aps[cls] = {th: calc_ap(mds[th]) for th in dist_ths}
        label_tp[cls] = {}
        md_tp = mds[DIST_TH_TP] if DIST_TH_TP in mds else \
            accumulate(gts, preds, cls, DIST_TH_TP)
        for m in TP_METRICS:
            if m in TP_EXCLUDE.get(cls, ()):
                label_tp[cls][m] = float("nan")
            else:
                label_tp[cls][m] = calc_tp(md_tp, m)

    mean_ap = float(np.mean([label_aps[c][th] for c in class_names
                             for th in dist_ths]))
    tp_errors = {m: float(np.nanmean([label_tp[c][m]
                                      for c in class_names]))
                 for m in TP_METRICS}
    # devkit tp_scores: a NaN mean error scores 0 but still counts in
    # the denominator (len(TP_METRICS))
    tp_scores = {m: (0.0 if np.isnan(e) else max(0.0, 1.0 - e))
                 for m, e in tp_errors.items()}
    nd = (MEAN_AP_WEIGHT * mean_ap + sum(tp_scores.values())) \
        / (MEAN_AP_WEIGHT + len(TP_METRICS))
    return {
        "mean_ap": mean_ap, "nd_score": float(nd),
        "label_aps": label_aps, "label_tp_errors": label_tp,
        "tp_errors": tp_errors, "tp_scores": tp_scores,
    }


def evaluate_native(result_path: str,
                    ann_file: Optional[str] = None,
                    infos: Optional[Sequence[Dict]] = None,
                    ) -> Dict[str, float]:
    """Devkit-free ``evaluate_nuscenes`` drop-in: submission json +
    infos pkl → the same summary-metric dict keys."""
    with open(result_path) as f:
        results = json.load(f)["results"]
    if infos is None:
        import pickle
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
    # partial submissions (--eval-samples / --max-samples) evaluate
    # against the GT of the submitted samples only — the devkit instead
    # asserts full-split coverage, so this is a strict extension; a
    # coverage field + warning keep partial-split numbers visibly
    # distinguishable from full-split ones (a truncated submission from
    # an upstream bug must not masquerade as a full eval)
    n_total = len(infos)
    infos = [i for i in infos if i["token"] in results]
    if len(infos) < n_total:
        import warnings
        warnings.warn(
            f"submission covers {len(infos)}/{n_total} samples of the "
            f"split; metrics below are PARTIAL-split numbers")
    m = evaluate_detections(results, infos)
    return {
        "coverage": len(infos) / max(n_total, 1),
        "mAP": m["mean_ap"], "NDS": m["nd_score"],
        "mATE": m["tp_errors"]["trans_err"],
        "mASE": m["tp_errors"]["scale_err"],
        "mAOE": m["tp_errors"]["orient_err"],
        "mAVE": m["tp_errors"]["vel_err"],
        "mAAE": m["tp_errors"]["attr_err"],
    }
