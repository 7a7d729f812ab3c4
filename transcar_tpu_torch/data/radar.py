"""Radar token featurization — 36-dim, 1500-token buffer.

This is the reference's in-``forward()`` radar block
(detr3d_head.py:301-536) moved into the input pipeline (SURVEY.md §7
inversion #1): deterministic given the sample, so the model stays pure.

nuScenes radar point columns (detr3d_head.py:498):
  (0)x (1)y (2)z (3)dyn_prop (4)id (5)rcs (6)vx (7)vy (8)vx_comp (9)vy_comp
  (10)is_quality_valid (11)ambig_state (12)x_rms (13)y_rms (14)invalid_state
  (15)pdh0 (16)vx_rms (17)vy_rms

36-dim token layout (matching the reference's concat order, :505-510):
  [0:7)   x, y, z, id, rcs, is_quality_valid, invalid_state  (cols 0,1,2,4,5,10,14)
  [7:9)   relative timestamp duplicated ×2 (t_lag − max_lag ≤ 0, :453-456)
  [9:11)  position offset = v_comp · t_rel (:457)
  [11:13) compensated velocity rotated radar→lidar frame, z zeroed (:317-321)
  [13:15) raw velocity rotated likewise (:323-327)
  [15:23) dyn_prop one-hot(8)     (:384-385)
  [23:28) ambig_state one-hot(5)  (:387-388)
  [28:36) pdh0 one-hot(8)         (:390-391)

Buffer semantics (:526-530): fixed [1500, 36] filled with the 500.0
sentinel in EVERY column (``radar_tokens[:,0,:] = 500`` writes the whole
buffer), then the first min(N, 1500) real points; overflow silently drops —
kept for parity, the cap is a config knob.

The port's copy of ``transcar_tpu/data/radar.py``, with the same two
featurizer routes (the C++ tokenizer of ``native/``, else numpy);
:data:`featurize_routes` counts the samples each route featurized.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np

#: samples featurized by each route of :func:`load_radar_tokens` (the
#: loader's threads add under :data:`_routes_lock`)
featurize_routes = {"native": 0, "numpy": 0}
_routes_lock = threading.Lock()

RADAR_CHANNELS = (
    "RADAR_FRONT", "RADAR_FRONT_LEFT", "RADAR_FRONT_RIGHT",
    "RADAR_BACK_LEFT", "RADAR_BACK_RIGHT",
)

POINT_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def _one_hot(values: np.ndarray, num: int) -> np.ndarray:
    n = values.shape[0]
    out = np.zeros((n, num), np.float64)
    out[np.arange(n), values.astype(int)] = 1.0
    return out


def _rotate_vel(vel_xy: np.ndarray, radar_rot: np.ndarray,
                ref_rot: np.ndarray) -> np.ndarray:
    """[2, N] radar-frame velocity → lidar frame, z zeroed (:317-321)."""
    v3 = np.vstack([vel_xy, np.zeros((1, vel_xy.shape[1]))])
    v3 = ref_rot.T @ (radar_rot @ v3)
    v3[2, :] = 0.0
    return v3


def featurize_radar_channel(points: np.ndarray, times: np.ndarray,
                            radar_rot: np.ndarray,
                            ref_rot: np.ndarray) -> np.ndarray:
    """One radar channel's multisweep points → [N, 36] features.

    Args:
      points: [18, N] devkit ``RadarPointCloud.points`` (already transformed
        into the lidar frame by ``from_file_multisweep``).
      times: [1, N] time lags (ref_time − sweep_time, seconds).
      radar_rot / ref_rot: [3, 3] calibrated-sensor rotation matrices of the
        radar and the reference (LIDAR_TOP) sensor.
    """
    pts = points.T                                   # [N, 18]
    n = pts.shape[0]
    v_comp = _rotate_vel(points[8:10], radar_rot, ref_rot)   # [3, N]
    v_raw = _rotate_vel(points[6:8], radar_rot, ref_rot)

    if times.shape[1] != 0:
        t_rel = times - np.max(times)                # ≤ 0 (:453-455)
    else:
        t_rel = times
    t2 = np.repeat(t_rel.T, 2, axis=1)               # [N, 2]
    offset = v_comp.T[:, :2] * t2                    # (:457)

    base = pts[:, [0, 1, 2, 4, 5, 10, 14]]
    return np.concatenate([
        base, t2, offset, v_comp.T[:, :2], v_raw.T[:, :2],
        _one_hot(pts[:, 3], 8), _one_hot(pts[:, 11], 5),
        _one_hot(pts[:, 15], 8),
    ], axis=1)


def build_radar_tokens(per_channel: Dict[str, Tuple[np.ndarray, np.ndarray]],
                       rotations: Dict[str, np.ndarray],
                       ref_rot: np.ndarray,
                       num_tokens: int = 1500,
                       pad_value: float = 500.0,
                       point_range=POINT_RANGE) -> np.ndarray:
    """Concatenate the 5 radar channels, range-filter, pad to the buffer.

    Args:
      per_channel: channel → (points [18, N], times [1, N]).
      rotations: channel → [3, 3] radar rotation.
      ref_rot: [3, 3] LIDAR_TOP rotation.
    Returns:
      [num_tokens, 36] float32 token buffer.
    """
    feats = [
        featurize_radar_channel(*per_channel[ch], rotations[ch], ref_rot)
        for ch in RADAR_CHANNELS if ch in per_channel
    ]
    allpts = (np.concatenate(feats, axis=0)
              if feats else np.zeros((0, 36), np.float64))
    lo = point_range[:3]
    hi = point_range[3:]
    keep = ((allpts[:, 0] > lo[0]) & (allpts[:, 1] > lo[1])
            & (allpts[:, 2] > lo[2]) & (allpts[:, 0] < hi[0])
            & (allpts[:, 1] < hi[1]) & (allpts[:, 2] < hi[2]))
    allpts = allpts[keep]

    tokens = np.full((num_tokens, 36), pad_value, np.float32)
    fill = min(num_tokens, allpts.shape[0])
    tokens[:fill] = allpts[:fill].astype(np.float32)
    return tokens


def empty_radar_tokens(num_tokens: int = 1500,
                       pad_value: float = 500.0) -> np.ndarray:
    """All-sentinel token buffer = "no radar returns this sample".

    Semantically exact degradation: every token sits at the x=500 pad
    sentinel (detr3d_head.py:526-530), so the fusion distance masks see
    no visible token and queries pass through un-updated (:573-581) —
    the same behavior the reference exhibits for a sample whose radar
    points all fall outside the range filter."""
    return np.full((num_tokens, 36), pad_value, np.float32)


def load_radar_tokens(nusc, sample_token: str, nsweeps: int = 5,
                      num_tokens: int = 1500,
                      use_native: bool = True) -> np.ndarray:
    """Sample token → [num_tokens, 36] buffer, matching the reference
    call pattern (detr3d_head.py:305-315) through the devkit-free
    ingestion in ``data/radar_io.py`` (native .pcd reader + multisweep).

    ``nusc``: anything with ``get(table, token)`` + ``dataroot`` — a
    :class:`data.radar_io.NuScenesTables` (no devkit
    needed) or a devkit ``NuScenes`` object interchangeably.
    Featurization runs through the C++ tokenizer (``native/``)
    when built, else the numpy path — parity-tested identical."""
    from transcar_tpu_torch.data.radar_io import radar_multisweep
    from transcar_tpu_torch.eval.submission import quat_to_rot

    sample = nusc.get("sample", sample_token)
    ref_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
    ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
    ref_rot = quat_to_rot(np.asarray(ref_cs["rotation"], np.float64))

    per_channel, rotations = {}, {}
    for ch in RADAR_CHANNELS:
        points, times = radar_multisweep(
            nusc, sample, chan=ch, ref_chan="LIDAR_TOP", nsweeps=nsweeps)
        sd = nusc.get("sample_data", sample["data"][ch])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        per_channel[ch] = (points, times)
        rotations[ch] = quat_to_rot(np.asarray(cs["rotation"],
                                               np.float64))

    if use_native:
        try:
            from transcar_tpu_torch import native
            tokens = native.radar_featurize(
                [per_channel[ch] for ch in RADAR_CHANNELS],
                [rotations[ch] for ch in RADAR_CHANNELS], ref_rot,
                num_tokens=num_tokens)
            with _routes_lock:
                featurize_routes["native"] += 1
            return tokens
        except Exception:
            pass   # no compiler / load failure → numpy path
    tokens = build_radar_tokens(per_channel, rotations, ref_rot,
                                num_tokens=num_tokens)
    with _routes_lock:
        featurize_routes["numpy"] += 1
    return tokens
