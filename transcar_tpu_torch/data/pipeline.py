"""Host-side multi-view image pipeline (C11 of SURVEY.md §2).

Numpy re-implementations of the reference pipeline ops
(datasets/pipelines/transform_3d.py) plus the upstream mmdet3d loaders the
configs use (config :157-184):

  * load_multiview_images     — LoadMultiViewImageFromFiles(to_float32)
  * photometric_distortion    — PhotoMetricDistortionMultiViewImage (:96-192)
  * normalize_images          — NormalizeMultiviewImage / mmcv.imnormalize
  * pad_to_divisor            — PadMultiViewImage(size_divisor=32) (:8-56)

Images flow as float32 BGR HWC (the caffe convention of the primary config:
mean (103.53, 116.28, 123.675), std 1, to_rgb=False) and are stacked to
[N_cams, H, W, 3] at the end.

The port's copy of ``transcar_tpu/data/pipeline.py``, with the same two
decode routes for the uint8 wire: libjpeg in one pass (``native``), else
PIL.  :data:`decode_routes` counts the camera rings each route decoded
and :data:`last_fallback` keeps why the native route last gave way, so a
caller can tell which one ran.
"""
from __future__ import annotations

from typing import List, Sequence

import threading

import numpy as np

#: camera rings decoded by each route of :func:`load_multiview_stack_u8`
#: (the loader's threads add under :data:`_routes_lock`)
decode_routes = {"native": 0, "pil": 0}
#: why the native route last gave way to PIL (None until it has)
last_fallback = None
_routes_lock = threading.Lock()


def load_multiview_images(paths: Sequence[str]) -> List[np.ndarray]:
    """Read images as float32 BGR HWC (mmcv.imread default is BGR)."""
    from PIL import Image

    imgs = []
    for p in paths:
        rgb = np.asarray(Image.open(p).convert("RGB"), dtype=np.float32)
        imgs.append(rgb[..., ::-1].copy())           # → BGR
    return imgs


def load_multiview_images_u8(paths: Sequence[str]) -> List[np.ndarray]:
    """Read images as uint8 BGR HWC — the on-device-normalize wire format.

    Skips the float32 round trip entirely (decode already yields uint8;
    the old u8 route decoded→fp32→rint→u8, two full-image conversions
    that are exactly identity).  Host float math is poison for loader
    throughput: numpy ufuncs hold the GIL, so the thread-pool workers
    serialize on it (PIL's decoder releases the GIL, so decode itself
    does parallelize)."""
    from PIL import Image

    imgs = []
    for p in paths:
        rgb = np.asarray(Image.open(p).convert("RGB"))
        imgs.append(rgb[..., ::-1].copy())           # → BGR, stays uint8
    return imgs


def load_multiview_stack_u8(paths: Sequence[str], pad_divisor: int = 32):
    """Decode a camera ring straight into one padded uint8 BGR stack.

    Returns ([N, H_pad, W_pad, 3] uint8, img_shape [2] int32).  For
    all-JPEG inputs with the native library available, libjpeg-turbo
    writes BGR scanlines directly into the padded slots
    (native/jpeg_decode.cpp) — decode, channel order, pad and stack in
    ONE pass, bit-identical to the PIL route (same libjpeg-turbo).
    Anything else (PNG fixtures, native build unavailable, decode
    error) falls back to the PIL route, :func:`_pil_stack_u8`."""
    global last_fallback
    if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        try:
            from PIL import Image

            from transcar_tpu_torch import native

            datas = []
            for p in paths:
                with open(p, "rb") as f:
                    datas.append(f.read())
            import io

            with Image.open(io.BytesIO(datas[0])) as im:   # header-only
                w, h = im.size
            ph = (h + pad_divisor - 1) // pad_divisor * pad_divisor
            pw = (w + pad_divisor - 1) // pad_divisor * pad_divisor
            stack, hw = native.decode_jpeg_multiview(datas, ph, pw)
            with _routes_lock:
                decode_routes["native"] += 1
            return stack, np.asarray(hw, np.int32)
        except Exception as e:                    # PIL fallback below
            last_fallback = f"{type(e).__name__}: {str(e)[:200]}"
    out = _pil_stack_u8(paths, pad_divisor)
    with _routes_lock:
        decode_routes["pil"] += 1
    return out


def _pil_stack_u8(paths: Sequence[str], pad_divisor: int):
    """The PIL route of :func:`load_multiview_stack_u8`: each image
    decoded by PIL, its BGR bytes taken in one pass (``tobytes("raw",
    "BGR")``) and copied once into its slot of the zeroed padded stack.
    The same bytes as the JAX package's PIL route (decode, BGR flip
    copy, pad copy, stack copy), with one copy where it makes four."""
    from PIL import Image

    out, hw = None, None
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            rgb = im if im.mode == "RGB" else im.convert("RGB")
            w, h = rgb.size
            if out is None:
                hw = (h, w)
                ph = (h + pad_divisor - 1) // pad_divisor * pad_divisor
                pw = (w + pad_divisor - 1) // pad_divisor * pad_divisor
                out = np.zeros((len(paths), ph, pw, 3), np.uint8)
            elif (h, w) != hw:
                raise ValueError(f"multi-view images disagree on size: "
                                 f"{hw} vs {(h, w)}")
            out[i, :h, :w] = np.frombuffer(
                rgb.tobytes("raw", "BGR"), np.uint8).reshape(h, w, 3)
    return out, np.asarray(hw, np.int32)


def normalize_images(imgs: List[np.ndarray], mean, std,
                     to_rgb: bool = False) -> List[np.ndarray]:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = []
    for img in imgs:
        x = img.astype(np.float32)
        if to_rgb:
            x = x[..., ::-1]
        out.append((x - mean) / std)
    return out


def pad_to_divisor(imgs: List[np.ndarray], divisor: int = 32,
                   pad_val: float = 0.0) -> List[np.ndarray]:
    out = []
    for img in imgs:
        h, w = img.shape[:2]
        ph = (h + divisor - 1) // divisor * divisor
        pw = (w + divisor - 1) // divisor * divisor
        if (ph, pw) != (h, w):
            img = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)),
                         constant_values=pad_val)
        out.append(img)
    return out


# ---------------------------------------------------------------------------
# photometric distortion (train only)
# ---------------------------------------------------------------------------

def _bgr2hsv(img, xp=np):
    """float32 BGR [0,255] → HSV with H in degrees (mmcv/cv2 semantics).

    Branch-light formulation: one shared division for the hue sector
    instead of three (the per-sector offsets 120°/240° become
    2Δ/4Δ added to the numerator, which is algebraically identical).

    ``xp`` selects the array namespace (numpy on the host route); the
    on-device aug of ``train/step.py`` computes the same formula in
    torch, and a CPU test holds the two together."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    maxc = xp.maximum(xp.maximum(r, g), b)
    minc = xp.minimum(xp.minimum(r, g), b)
    delta = maxc - minc
    s = xp.where(maxc > 0, delta / xp.maximum(maxc, np.float32(1e-12)),
                 np.float32(0.0))
    num = xp.where(maxc == r, g - b,
                   xp.where(maxc == g, (b - r) + delta * np.float32(2.0),
                            (r - g) + delta * np.float32(4.0)))
    h = num * (np.float32(60.0) / xp.maximum(delta, np.float32(1e-12)))
    h = xp.where(delta == 0, np.float32(0.0), h)
    h = xp.where(h < 0, h + np.float32(360.0), h)
    return xp.stack([h, s, maxc], axis=-1)


def _hsv2bgr(img, xp=np):
    """Inverse of :func:`_bgr2hsv` via the branch-free "wheel" formula —
    channel(n) = V − V·S·clip(min(k, 4−k), 0, 1) with k = (n + H/60) mod 6
    — which equals the classic p/q/t six-sector table exactly (the old
    np.choose formulation ran ~7× slower on the loader host path)."""
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    h60 = h * np.float32(1.0 / 60.0)
    vs = v * s

    def chan(n):
        k = (n + h60) % np.float32(6.0)
        w = xp.clip(xp.minimum(k, np.float32(4.0) - k),
                    np.float32(0.0), np.float32(1.0))
        return v - vs * w

    return xp.stack([chan(np.float32(1)), chan(np.float32(3)),
                     chan(np.float32(5))], axis=-1)


def draw_photometric_params(rng: np.random.Generator, n: int,
                            brightness_delta: float = 32.0,
                            contrast_range=(0.5, 1.5),
                            saturation_range=(0.5, 1.5),
                            hue_delta: float = 18.0):
    """Sample PhotoMetricDistortionMultiViewImage's per-image random
    choices (transform_3d.py:125-181: each sub-op fires with prob 0.5,
    uniform magnitudes, contrast before-or-after HSV by ``mode``) as
    ARRAYS, so the pixel math can run wherever it's cheapest — the
    TPU-native route applies it inside the jitted step
    (train/step.py::normalize_batch_images), where it fuses into the
    normalize for free and the host ships plain uint8.

    Returns (params [n, 5] float32 = (brightness, mode, contrast_alpha,
    saturation_alpha, hue_deg), perm [n, 3] int32 channel swap).
    Off-draws encode as the op's identity (0 / 1 / 0 / identity perm)."""
    params = np.zeros((n, 5), np.float32)
    perm = np.tile(np.arange(3, dtype=np.int32), (n, 1))
    for i in range(n):
        if rng.integers(2):
            params[i, 0] = rng.uniform(-brightness_delta, brightness_delta)
        params[i, 1] = rng.integers(2)                       # mode
        params[i, 2] = (rng.uniform(*contrast_range)
                        if rng.integers(2) else 1.0)
        params[i, 3] = (rng.uniform(*saturation_range)
                        if rng.integers(2) else 1.0)
        if rng.integers(2):
            params[i, 4] = rng.uniform(-hue_delta, hue_delta)
        if rng.integers(2):
            perm[i] = rng.permutation(3).astype(np.int32)
    return params, perm


def apply_photometric(img: np.ndarray, p: np.ndarray,
                      perm: np.ndarray) -> np.ndarray:
    """Apply one image's drawn distortion (host float32 reference path).

    Matches the reference op order: brightness → contrast (mode 1) →
    HSV → saturation → hue → BGR → contrast (mode 0) → channel swap.
    The HSV round trip runs UNCONDITIONALLY, like the reference
    (transform_3d.py:153-168) and the device path: it is NOT an identity
    for out-of-gamut pixels — a brightness-darkened all-negative pixel
    has V = max ≤ 0, which forces S = 0 and collapses it to grey — so
    skipping it on identity saturation/hue draws would diverge
    (measured 17-intensity differences on dark pixels)."""
    img = img.astype(np.float32) + p[0]
    if p[1] == 1 and p[2] != 1.0:
        img = img * p[2]
    hsv = _bgr2hsv(img)
    hsv[..., 1] *= p[3]
    h = hsv[..., 0] + p[4]
    h[h > 360] -= 360
    h[h < 0] += 360
    hsv[..., 0] = h
    img = _hsv2bgr(hsv)
    if p[1] == 0 and p[2] != 1.0:
        img = img * p[2]
    return img[..., perm]


def photometric_distortion(
    imgs: List[np.ndarray],
    rng: np.random.Generator,
    brightness_delta: float = 32.0,
    contrast_range=(0.5, 1.5),
    saturation_range=(0.5, 1.5),
    hue_delta: float = 18.0,
) -> List[np.ndarray]:
    """Per-image independent distortion (transform_3d.py:125-181) —
    host float32 path (normalize_on_device=False)."""
    params, perms = draw_photometric_params(
        rng, len(imgs), brightness_delta, contrast_range,
        saturation_range, hue_delta)
    return [apply_photometric(img, params[i], perms[i])
            for i, img in enumerate(imgs)]


def stack_views(imgs: List[np.ndarray], dtype=np.float32) -> np.ndarray:
    return np.stack(imgs, axis=0).astype(dtype)


# ---------------------------------------------------------------------------
# geometric multi-view transforms (transform_3d.py:196-305)
# ---------------------------------------------------------------------------

def crop_images(imgs: List[np.ndarray], size) -> List[np.ndarray]:
    """CropMultiViewImage (:196-220): top-left crop to ``size``."""
    return [img[: size[0], : size[1], ...] for img in imgs]


def _resize_bilinear(img: np.ndarray, hw) -> np.ndarray:
    """cv2.resize(bilinear)-compatible resize (align_corners=False)."""
    h, w = hw
    sh, sw = img.shape[:2]
    ys = (np.arange(h) + 0.5) * sh / h - 0.5
    xs = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, sw - 1)
    y1 = np.clip(y0 + 1, 0, sh - 1)
    x1 = np.clip(x0 + 1, 0, sw - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx).astype(img.dtype)


def random_scale_images(imgs: List[np.ndarray], lidar2img: np.ndarray,
                        gt_boxes: np.ndarray,
                        rng: np.random.Generator,
                        scales=(0.5, 1.0, 1.5)):
    """RandomScaleImageMultiViewImage (:224-258): rescales images AND the
    lidar2img matrices AND gt box geometry by one random scale."""
    s = float(rng.choice(np.asarray(scales)))
    h, w = imgs[0].shape[:2]
    new_hw = (int(h * s), int(w * s))
    imgs = [_resize_bilinear(img, new_hw) for img in imgs]
    scale = np.eye(4, dtype=lidar2img.dtype)
    scale[0, 0] = scale[1, 1] = s
    lidar2img = np.einsum("ij,njk->nik", scale, lidar2img)
    gt_boxes = gt_boxes.copy()
    if len(gt_boxes):
        gt_boxes[:, :6] *= s
    return imgs, lidar2img, gt_boxes, s


def horizontal_flip(imgs: List[np.ndarray], lidar2img: np.ndarray,
                    gt_boxes: np.ndarray):
    """Horizontal flip of images + geometry + boxes — the *geometrically
    corrected* variant of HorizontalRandomFlipMultiViewImage (:262-305),
    NOT a parity port.  The reference composes a lidar-frame y-mirror into
    lidar2cam but then only mirrors the principal point (cx → w−cx,
    keeping +fx), so a flipped box re-projects to u = +fx·x_c/z + (w−cx) —
    the mirror of where it actually appears in the flipped image for any
    off-axis point.  Here the full image-x mirror [−fx, 0, w−cx] is folded
    into lidar2img so flipped boxes land exactly on their flipped pixels.
    Boxes flip as in LiDARInstance3DBoxes.flip('horizontal'): y → −y,
    yaw → −yaw, vy → −vy.  (Unused by every shipped preset, as in the
    reference configs.)"""
    w = imgs[0].shape[1]
    imgs = [img[:, ::-1, ...].copy() for img in imgs]
    flip = np.eye(4, dtype=lidar2img.dtype)
    flip[1, 1] = -1.0
    mirror = np.eye(4, dtype=lidar2img.dtype)
    mirror[0, 0] = -1.0
    mirror[0, 2] = w
    lidar2img = np.einsum("ij,njk,kl->nil", mirror, lidar2img, flip)
    gt_boxes = gt_boxes.copy()
    if len(gt_boxes):
        gt_boxes[:, 1] *= -1
        gt_boxes[:, 6] *= -1
        if gt_boxes.shape[1] > 8:
            gt_boxes[:, 8] *= -1
    return imgs, lidar2img, gt_boxes
