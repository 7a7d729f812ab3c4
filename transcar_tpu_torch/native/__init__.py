"""ctypes bindings for the host-side C++ helpers of the data pipeline
(``transcar_tpu/native``).

Two shared libraries, each built by ``g++`` through this directory's
``Makefile`` at its first use, never at import:

  * ``libtranscar_native`` (``lapjv.cpp``, ``radar_featurize.cpp``):
    ``lapjv``, ``lapjv_batched`` and ``radar_featurize``, the 36-dim radar
    tokenizer;
  * ``libtranscar_jpeg`` (``jpeg_decode.cpp``, linked with ``-ljpeg``):
    ``decode_jpeg_multiview``.

The JAX package builds one library, so a host without libjpeg's headers
loses its radar featurizer too; here only the decoder needs libjpeg.  Each
library lands in ``transcar_tpu_torch/build/native/`` (listed in
``.gitignore``) under a name keyed by a hash of its sources and the
Makefile, so an edited source rebuilds and nothing is written into this
directory.  A failed build raises; the callers (``data/pipeline.py``,
``data/radar.py``) then take their PIL / numpy routes, as the JAX
package's do, and count which route ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Dict, Optional

import numpy as np

SRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "build" / "native"
#: library → its sources (the Makefile's targets)
SOURCES = {"libtranscar_native": ("lapjv.cpp", "radar_featurize.cpp"),
           "libtranscar_jpeg": ("jpeg_decode.cpp",)}

_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> pathlib.Path:
    """Where library ``name`` for the current sources lives (built or not)."""
    digest = hashlib.sha256((SRC_DIR / "Makefile").read_bytes())
    for src in SOURCES[name]:
        digest.update(src.encode())
        digest.update((SRC_DIR / src).read_bytes())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Build library ``name`` unless it exists for these sources; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
    proc = subprocess.run(
        ["make", "-s", "-C", str(SRC_DIR), f"{name}.so", f"OUT={tmp}"],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)        # atomic: a concurrent build never sees half
    return so


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build(name)))
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int)
    dptr = ctypes.POINTER(ctypes.c_double)
    if name == "libtranscar_native":
        lib.lapjv_solve.restype = ctypes.c_int
        lib.lapjv_solve.argtypes = [fptr, ctypes.c_int, ctypes.c_int, iptr]
        lib.lapjv_solve_batched.restype = ctypes.c_int
        lib.lapjv_solve_batched.argtypes = [
            fptr, iptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, iptr]
        lib.radar_featurize.restype = ctypes.c_int
        lib.radar_featurize.argtypes = [
            ctypes.POINTER(fptr), ctypes.POINTER(fptr), iptr, ctypes.c_int,
            dptr, dptr, fptr, ctypes.c_float, ctypes.c_int, fptr]
    else:
        uptr = ctypes.POINTER(ctypes.c_ubyte)
        lib.jpeg_decode_bgr.restype = ctypes.c_int
        lib.jpeg_decode_bgr.argtypes = [
            uptr, ctypes.c_ulong, uptr, ctypes.c_int, ctypes.c_int, iptr,
            iptr]
    _libs[name] = lib
    return lib


def lapjv(cost: np.ndarray, n_rows: Optional[int] = None) -> np.ndarray:
    """cost: [R, C] float32 (R ≤ C).  Returns col4row [R] int32."""
    lib = _load("libtranscar_native")
    cost = np.ascontiguousarray(cost, np.float32)
    r, c = cost.shape
    n = r if n_rows is None else int(n_rows)
    out = np.full((r,), -1, np.int32)
    rc = lib.lapjv_solve(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        raise RuntimeError(f"lapjv_solve failed with code {rc}")
    return out


def lapjv_batched(costs: np.ndarray, n_rows_per: np.ndarray) -> np.ndarray:
    """costs: [B, R, C] float32; n_rows_per: [B] int32 → [B, R] int32."""
    lib = _load("libtranscar_native")
    costs = np.ascontiguousarray(costs, np.float32)
    n_rows_per = np.ascontiguousarray(n_rows_per, np.int32)
    b, r, c = costs.shape
    out = np.full((b, r), -1, np.int32)
    rc = lib.lapjv_solve_batched(
        costs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_rows_per.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        b, r, c, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        raise RuntimeError(f"lapjv_solve_batched failed with code {rc}")
    return out


def radar_featurize(per_channel, rotations, ref_rot,
                    num_tokens: int = 1500, pad_value: float = 500.0,
                    point_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
                    ) -> np.ndarray:
    """Native counterpart of data.radar.build_radar_tokens.

    Args:
      per_channel: ordered list of (points [18, N] float32, times [1, N])
        per radar channel.
      rotations: matching list of [3, 3] float64 radar rotations.
      ref_rot: [3, 3] float64 LIDAR_TOP rotation.
    Returns:
      [num_tokens, 36] float32 token buffer.
    """
    lib = _load("libtranscar_native")
    n_ch = len(per_channel)
    pts = [np.ascontiguousarray(p, np.float32) for p, _ in per_channel]
    tms = [np.ascontiguousarray(t.reshape(-1), np.float32)
           for _, t in per_channel]
    counts = np.asarray([p.shape[1] for p in pts], np.int32)
    rots = np.ascontiguousarray(
        np.stack([np.asarray(r, np.float64) for r in rotations]).reshape(-1))
    refr = np.ascontiguousarray(np.asarray(ref_rot, np.float64).reshape(-1))
    rng6 = np.asarray(point_range, np.float32)
    out = np.empty((num_tokens, 36), np.float32)

    fptr = ctypes.POINTER(ctypes.c_float)
    pts_arr = (fptr * n_ch)(*[p.ctypes.data_as(fptr) for p in pts])
    tms_arr = (fptr * n_ch)(*[t.ctypes.data_as(fptr) for t in tms])
    lib.radar_featurize(
        pts_arr, tms_arr,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_ch,
        rots.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        refr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rng6.ctypes.data_as(fptr), ctypes.c_float(pad_value), num_tokens,
        out.ctypes.data_as(fptr))
    return out


def decode_jpeg_multiview(datas, pad_h: int, pad_w: int) -> "np.ndarray":
    """Decode N JPEG byte strings into one pre-padded uint8 BGR stack.

    Returns ([N, pad_h, pad_w, 3] uint8, (h, w) of the first image).
    One native pass per image: libjpeg-turbo writes BGR scanlines
    directly into the padded slot (no flip/pad/stack copies — see
    jpeg_decode.cpp).  Raises on decode failure or images larger than
    the padded buffer; callers fall back to the PIL route."""
    lib = _load("libtranscar_jpeg")
    n = len(datas)
    out = np.zeros((n, pad_h, pad_w, 3), np.uint8)
    gh = ctypes.c_int(0)
    gw = ctypes.c_int(0)
    hw = None
    uptr = ctypes.POINTER(ctypes.c_ubyte)
    for i, data in enumerate(datas):
        buf = np.frombuffer(data, np.uint8)
        rc = lib.jpeg_decode_bgr(
            buf.ctypes.data_as(uptr), ctypes.c_ulong(len(data)),
            out[i].ctypes.data_as(uptr), pad_h, pad_w,
            ctypes.byref(gh), ctypes.byref(gw))
        if rc != 0:
            raise RuntimeError(f"jpeg_decode_bgr failed with code {rc}")
        if hw is None:
            hw = (gh.value, gw.value)
        elif hw != (gh.value, gw.value):
            raise RuntimeError("multi-view images disagree on size: "
                               f"{hw} vs {(gh.value, gw.value)}")
    return out, hw
