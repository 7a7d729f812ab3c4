"""Headless BEV rendering of detection results
(``transcar_tpu/eval/bev_plot.py``), drawn with PIL.

The reference's ``--show`` / ``--show-dir`` (``tools/test.py:43-45``) and
``tools/misc/visualize_results.py`` render predictions with the mmdet3d
Open3D / mlab visualizer, which needs a display and the raw dataset.  This
draws the top-down (bird's-eye-view) box plot straight from a nuScenes
submission json: rotated footprints with heading ticks and velocity
arrows, per-class colours, gated by score, into PNGs, so it runs wherever
the results file is.

The JAX package draws with matplotlib, which the GPU host does not have;
here PIL's ``ImageDraw`` draws the same geometry.  The geometry is kept in
functions of its own (:func:`gated`, :func:`ego_origin`,
:func:`_box_corners_bev`, :func:`box_geometry`), held bit for bit against
what the JAX module draws; the pixels are not.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from transcar_tpu_torch.core.config import CLASS_NAMES, PC_RANGE
from transcar_tpu_torch.data.export2d import quat_yaw

_COLORS = {
    "car": "#1f77b4", "truck": "#ff7f0e", "trailer": "#2ca02c",
    "bus": "#d62728", "construction_vehicle": "#9467bd",
    "bicycle": "#8c564b", "motorcycle": "#e377c2", "pedestrian": "#7f7f7f",
    "traffic_cone": "#bcbd22", "barrier": "#17becf",
}
#: Side of the square figure, pixels (the JAX figure: 8 in at 100 dpi).
CANVAS = 800
#: Summed |velocity| (m/s) above which a box gets a velocity arrow.
MIN_ARROW_SPEED = 0.2
GRID_M = 10.0


def gated(annos: List[Dict], score_thr: float) -> List[Dict]:
    """The records drawn: those scoring at least ``score_thr``."""
    return [a for a in annos if a["detection_score"] >= score_thr]


def ego_origin(kept: List[Dict]) -> np.ndarray:
    """The plot's origin: the mean box centre (so that global-frame
    submissions stay in frame), or (0, 0) with no box."""
    if not kept:
        return np.zeros(2)
    return np.array([a["translation"][:2] for a in kept]).mean(axis=0)


def _box_corners_bev(x, y, w, l, yaw):
    """[4, 2] footprint corners of a (gravity-centre) box in the plot
    frame."""
    dx, dy = l / 2.0, w / 2.0
    local = np.array([[dx, dy], [dx, -dy], [-dx, -dy], [-dx, dy]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([x, y])


def box_geometry(a: Dict, origin: np.ndarray) -> Dict:
    """What is drawn for record ``a`` around ``origin``: its centre,
    footprint corners [4, 2], the front mid-point the heading tick ends
    at, the velocity arrow (or None) and the stroke alpha."""
    x, y = np.asarray(a["translation"][:2]) - origin
    w, l = a["size"][0], a["size"][1]
    cor = _box_corners_bev(x, y, w, l, quat_yaw(a["rotation"]))
    vel = a.get("velocity", [0, 0])
    arrow = (vel[0], vel[1]) if abs(vel[0]) + abs(vel[1]) > MIN_ARROW_SPEED \
        else None
    return {"center": (x, y), "corners": cor,
            "front": (cor[0] + cor[1]) / 2.0, "arrow": arrow,
            "alpha": min(1.0, 0.25 + 0.75 * a["detection_score"])}


def _rgba(hex_color: str, alpha: float) -> tuple:
    h = hex_color.lstrip("#")
    return (int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16),
            int(round(255 * alpha)))


def render_bev(annos: List[Dict], out_png: str,
               pc_range=PC_RANGE, score_thr: float = 0.3,
               title: Optional[str] = None) -> int:
    """Draw one sample's detections top-down into ``out_png``; returns
    the number of boxes drawn.

    ``annos``: submission-json records (translation [global or ego],
    size wlh, rotation quaternion, velocity, detection_name / score).
    """
    from PIL import Image, ImageDraw

    kept = gated(annos, score_thr)
    origin = ego_origin(kept)
    half = (pc_range[3] - pc_range[0]) / 2.0
    scale = CANVAS / (2.0 * half)

    def px(x, y):          # plot metres (y up) → pixels (y down)
        return ((x + half) * scale, (half - y) * scale)

    img = Image.new("RGBA", (CANVAS, CANVAS), (255, 255, 255, 255))
    draw = ImageDraw.Draw(img, "RGBA")
    for g in np.arange(-half, half + 1e-6, GRID_M):
        draw.line([px(g, -half), px(g, half)], fill=(0, 0, 0, 40))
        draw.line([px(-half, g), px(half, g)], fill=(0, 0, 0, 40))
    for a in kept:
        geo = box_geometry(a, origin)
        color = _rgba(_COLORS.get(a["detection_name"], "#000000"),
                      geo["alpha"])
        cor = [px(*p) for p in geo["corners"]]
        draw.polygon(cor, outline=color, width=2)
        draw.line([px(*geo["center"]), px(*geo["front"])], fill=color,
                  width=1)
        if geo["arrow"] is not None:
            _arrow(draw, px, geo["center"], geo["arrow"], color)
    ex, ey = px(0.0, 0.0)                       # the ego, pointing up
    draw.polygon([(ex, ey - 8), (ex - 6, ey + 5), (ex + 6, ey + 5)],
                 fill=(0, 0, 0, 255))
    if title:
        draw.text((6, 4), title, fill=(0, 0, 0, 255))
    y = 4
    for name, c in _COLORS.items():             # the legend
        if name in CLASS_NAMES:
            draw.line([(CANVAS - 150, y + 6), (CANVAS - 130, y + 6)],
                      fill=_rgba(c, 1.0), width=3)
            draw.text((CANVAS - 124, y), name, fill=(0, 0, 0, 255))
            y += 14
    img.convert("RGB").save(out_png)
    return len(kept)


def _arrow(draw, px, start, vel, color) -> None:
    """Velocity arrow from ``start`` by ``vel`` metres, its head 0.6 m
    wide included in its length."""
    (x, y), (vx, vy) = start, vel
    length = float(np.hypot(vx, vy))
    ux, uy = vx / length, vy / length
    head = min(0.9, length)
    bx, by = x + vx - ux * head, y + vy - uy * head
    draw.line([px(x, y), px(bx, by)], fill=color, width=2)
    draw.polygon([px(x + vx, y + vy), px(bx - uy * 0.3, by + ux * 0.3),
                  px(bx + uy * 0.3, by - ux * 0.3)], fill=color)


def render_submission(results_json: str, out_dir: str,
                      score_thr: float = 0.3,
                      max_samples: Optional[int] = None) -> List[str]:
    """Render every sample of a submission json into ``out_dir``; returns
    the PNG paths, one a sample."""
    with open(results_json) as f:
        sub = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, (token, annos) in enumerate(sub["results"].items()):
        if max_samples is not None and i >= max_samples:
            break
        out = os.path.join(out_dir, f"{i:04d}_{token[:16]}.png")
        n = render_bev(annos, out, score_thr=score_thr,
                       title=f"{token} ({len(annos)} dets)")
        written.append(out)
        if i < 3 or n:
            print(f"rendered {out} ({n} boxes ≥{score_thr})")
    return written
