"""Devkit-free nuScenes radar ingestion: .pcd reader + multisweep.

The reference loads radar inside the model forward through
nuscenes-devkit (``detr3d_head.py:305-309`` →
``RadarPointCloud.from_file_multisweep``), which needs the devkit
package *and* the raw dataset's table objects.  This module re-derives
that ingestion natively so the radar path runs anywhere the framework
runs — the devkit is no longer a hard dependency of TransCAR's own
contribution (VERDICT r3 item 1).

Three pieces, each restating the public devkit semantics
(``nuscenes/utils/data_classes.py`` ``RadarPointCloud.from_file`` /
``from_file_multisweep`` and ``nuscenes/utils/geometry_utils.py``
``transform_matrix`` — re-derived from the published file format and
transform definitions, no devkit code imported or copied):

  * :func:`read_radar_pcd` — binary PCD v0.7 parser with the devkit's
    default point filters (invalid_state ∈ {0}, dyn_prop ∈ 0..6,
    ambig_state == 3; the reference keeps these defaults —
    ``disable_filters`` is commented out at ``detr3d_head.py:303``),
  * :func:`radar_multisweep` — nsweeps accumulation walking the
    ``prev`` chain, with the sweep→ego→global→ego′→ref-sensor
    homogeneous transform chain on positions and per-sweep time lags,
  * :class:`NuScenesTables` — a minimal token-indexed reader of the
    nuScenes JSON tables (sample / sample_data / ego_pose /
    calibrated_sensor / sensor) exposing the same ``get(table, token)``
    + ``dataroot`` surface ``load_radar_tokens`` consumes, so either a
    devkit ``NuScenes`` object or this class can drive the loader.

Velocity columns are deliberately NOT transformed by the multisweep
chain — the devkit transforms positions only; the featurizer
(``data/radar.py``) applies its own radar→lidar rotation to the
velocity columns exactly as the reference does in-model
(``detr3d_head.py:317-327``).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from transcar_tpu_torch.eval.submission import quat_to_rot

# nuScenes radar PCD column order (see data/radar.py module docstring)
RADAR_NBR_DIMS = 18
_COL_DYN_PROP = 3
_COL_AMBIG = 11
_COL_INVALID = 14

# devkit RadarPointCloud class-default filters, kept by the reference
DEFAULT_INVALID_STATES = (0,)
DEFAULT_DYNPROP_STATES = tuple(range(7))
DEFAULT_AMBIG_STATES = (3,)

# PCD TYPE letter + SIZE → little-endian numpy dtype
_PCD_DTYPES = {
    ("F", 2): "<f2", ("F", 4): "<f4", ("F", 8): "<f8",
    ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4", ("I", 8): "<i8",
    ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4", ("U", 8): "<u8",
}


def read_radar_pcd(path: str,
                   invalid_states: Optional[Sequence[int]] = None,
                   dynprop_states: Optional[Sequence[int]] = None,
                   ambig_states: Optional[Sequence[int]] = None,
                   ) -> np.ndarray:
    """One radar sweep file → ``[n_fields, N]`` float64 points.

    Binary PCD v0.7 with the nuScenes radar field layout; matches
    ``RadarPointCloud.from_file``: fixed 11-line header, binary payload,
    the NaN-in-first-point empty-cloud convention, and the three
    state filters applied in invalid→dynprop→ambig order.
    """
    assert path.endswith(".pcd"), f"unsupported filetype: {path}"
    meta: List[str] = []
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip().decode("utf-8")
            meta.append(line)
            if line.startswith("DATA"):
                break
        payload = f.read()

    assert meta[0].startswith("#"), "first line must be a comment"
    assert meta[1].startswith("VERSION"), "second line must be VERSION"
    fields = meta[2].split(" ")[1:]
    sizes = [int(s) for s in meta[3].split(" ")[1:]]
    types = meta[4].split(" ")[1:]
    counts = meta[5].split(" ")[1:]
    width = int(meta[6].split(" ")[1])
    height = int(meta[7].split(" ")[1])
    data_kind = meta[10].split(" ")[1]
    assert width > 0
    assert all(c == "1" for c in counts), "COUNT != 1 not supported"
    assert height == 1, "height != 1 not supported"
    assert data_kind == "binary", f"DATA {data_kind} not supported"

    dtype = np.dtype([(name, _PCD_DTYPES[(t, s)])
                      for name, t, s in zip(fields, types, sizes)])
    n_fields = len(fields)
    assert len(payload) >= width * dtype.itemsize, "truncated payload"
    rec = np.frombuffer(payload, dtype=dtype, count=width)
    points = np.stack([rec[name].astype(np.float64) for name in fields])

    # NaN in the first point marks an intentionally-empty cloud
    if np.any(np.isnan(points[:, 0])):
        return np.zeros((n_fields, 0), np.float64)

    inv = DEFAULT_INVALID_STATES if invalid_states is None \
        else tuple(invalid_states)
    dyn = DEFAULT_DYNPROP_STATES if dynprop_states is None \
        else tuple(dynprop_states)
    amb = DEFAULT_AMBIG_STATES if ambig_states is None \
        else tuple(ambig_states)
    points = points[:, np.isin(points[_COL_INVALID], inv)]
    points = points[:, np.isin(points[_COL_DYN_PROP], dyn)]
    points = points[:, np.isin(points[_COL_AMBIG], amb)]
    return points


def write_radar_pcd(path: str, points: np.ndarray) -> None:
    """Inverse of :func:`read_radar_pcd` for the nuScenes radar layout
    (18 fields) — fixture/synthetic-data generation; the devkit has no
    writer.  ``points``: [18, N] (values cast to each field's dtype)."""
    fields = ("x y z dyn_prop id rcs vx vy vx_comp vy_comp "
              "is_quality_valid ambig_state x_rms y_rms invalid_state "
              "pdh0 vx_rms vy_rms").split()
    sizes = [4, 4, 4, 1, 2, 4, 4, 4, 4, 4, 1, 1, 1, 1, 1, 1, 1, 1]
    types = ["F", "F", "F", "I", "I", "F", "F", "F", "F", "F",
             "I", "I", "I", "I", "I", "I", "I", "I"]
    points = np.asarray(points, np.float64)
    assert points.shape[0] == RADAR_NBR_DIMS
    n = points.shape[1]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
        "SIZE " + " ".join(str(s) for s in sizes),
        "TYPE " + " ".join(types),
        "COUNT " + " ".join(["1"] * len(fields)),
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        "DATA binary",
    ]) + "\n"
    dtype = np.dtype([(name, _PCD_DTYPES[(t, s)])
                      for name, t, s in zip(fields, types, sizes)])
    rec = np.zeros(n, dtype)
    for i, name in enumerate(fields):
        rec[name] = points[i]
    with open(path, "wb") as f:
        f.write(header.encode("utf-8"))
        f.write(rec.tobytes())


def transform_matrix(translation: Sequence[float],
                     rotation_quat: Sequence[float],
                     inverse: bool = False) -> np.ndarray:
    """4×4 homogeneous transform from a translation + [w,x,y,z]
    quaternion; ``inverse=True`` returns the inverse transform."""
    rot = quat_to_rot(np.asarray(rotation_quat, np.float64))
    t = np.asarray(translation, np.float64)
    tm = np.eye(4)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = rot.T @ (-t)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    return tm


def remove_close(points: np.ndarray, radius: float) -> np.ndarray:
    """Drop points inside the |x|<r ∧ |y|<r box around the sensor
    (ego-vehicle returns)."""
    close = (np.abs(points[0]) < radius) & (np.abs(points[1]) < radius)
    return points[:, ~close]


def radar_multisweep(nusc, sample_rec: Dict, chan: str,
                     ref_chan: str = "LIDAR_TOP", nsweeps: int = 5,
                     min_distance: float = 1.0,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate ≤ ``nsweeps`` radar sweeps of ``chan`` into the
    reference sensor's frame at the reference timestamp
    (``RadarPointCloud.from_file_multisweep`` restatement).

    ``nusc``: devkit ``NuScenes`` or :class:`NuScenesTables` — anything
    with ``get(table, token)`` and ``dataroot``.
    Returns ``(points [18, M], times [1, M])`` with times = reference
    time − sweep time (seconds, newest sweep first in M order).
    """
    ref_sd = nusc.get("sample_data", sample_rec["data"][ref_chan])
    ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
    ref_cs = nusc.get("calibrated_sensor",
                      ref_sd["calibrated_sensor_token"])
    ref_time = 1e-6 * ref_sd["timestamp"]

    # ego(ref time) → ref sensor, and global → ego(ref time)
    ref_from_car = transform_matrix(ref_cs["translation"],
                                    ref_cs["rotation"], inverse=True)
    car_from_global = transform_matrix(ref_pose["translation"],
                                       ref_pose["rotation"], inverse=True)

    all_points = [np.zeros((RADAR_NBR_DIMS, 0), np.float64)]
    all_times = [np.zeros((1, 0), np.float64)]
    sd = nusc.get("sample_data", sample_rec["data"][chan])
    for _ in range(nsweeps):
        pts = read_radar_pcd(os.path.join(nusc.dataroot, sd["filename"]))
        pts = remove_close(pts, min_distance)

        # sweep sensor → ego(sweep time) → global
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        global_from_car = transform_matrix(pose["translation"],
                                           pose["rotation"])
        car_from_current = transform_matrix(cs["translation"],
                                            cs["rotation"])
        tm = (ref_from_car @ car_from_global
              @ global_from_car @ car_from_current)
        # positions only; velocity columns stay sensor-frame (devkit
        # PointCloud.transform touches rows 0:3 only)
        pts[:3] = (tm @ np.vstack([pts[:3],
                                   np.ones((1, pts.shape[1]))]))[:3]

        lag = ref_time - 1e-6 * sd["timestamp"]
        all_points.append(pts)
        all_times.append(np.full((1, pts.shape[1]), lag))

        if sd["prev"] == "":
            break
        sd = nusc.get("sample_data", sd["prev"])

    return (np.concatenate(all_points, axis=1),
            np.concatenate(all_times, axis=1))


class NuScenesTables:
    """Minimal devkit-free reader of the nuScenes JSON tables.

    Loads ``{dataroot}/{version}/{table}.json`` lazily, indexes records
    by token, and rebuilds the two derived structures the radar path
    needs (the devkit builds them in ``__make_reverse_index__``):
    ``sample_data["channel"]`` (via calibrated_sensor → sensor) and the
    key-frame ``sample["data"][channel]`` map.  Exposes the devkit
    surface ``load_radar_tokens`` consumes: ``get(table, token)``,
    ``dataroot``, and ``sample`` iteration via :meth:`tokens`.

    The loader's threads share one reader, so loading a table and
    building the index happen under a lock (the JAX package's reader
    relies on its caller indexing it before the threads start).
    """

    _RADAR_TABLES = ("sample", "sample_data", "ego_pose",
                     "calibrated_sensor", "sensor")

    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        self._tables: Dict[str, Dict[str, Dict]] = {}
        self._indexed = False
        self._lock = threading.RLock()

    def _load(self, table: str) -> Dict[str, Dict]:
        with self._lock:
            if table not in self._tables:
                path = os.path.join(self.dataroot, self.version,
                                    f"{table}.json")
                with open(path) as f:
                    rows = json.load(f)
                self._tables[table] = {r["token"]: r for r in rows}
            return self._tables[table]

    def _build_index(self) -> None:
        with self._lock:
            if not self._indexed:
                self._index()

    def _index(self) -> None:
        samples = self._load("sample")
        sensors = self._load("sensor")
        css = self._load("calibrated_sensor")
        for s in samples.values():
            s.setdefault("data", {})
        for sd in self._load("sample_data").values():
            chan = sensors[css[sd["calibrated_sensor_token"]]
                           ["sensor_token"]]["channel"]
            sd["channel"] = chan
            if sd.get("is_key_frame"):
                samples[sd["sample_token"]]["data"][chan] = sd["token"]
        self._indexed = True

    def get(self, table: str, token: str) -> Dict:
        if table in ("sample", "sample_data"):
            self._build_index()
        return self._load(table)[token]

    def tokens(self, table: str) -> List[str]:
        if table in ("sample", "sample_data"):
            self._build_index()
        return list(self._load(table).keys())
