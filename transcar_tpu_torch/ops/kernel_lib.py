"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into one shared
library with a plain C interface, loaded with ``ctypes``: a source that
includes no PyTorch header builds in seconds, where
``torch.utils.cpp_extension`` takes minutes.  The library lands in ``transcar_tpu_torch/build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused.

The build happens at first use, never at import: the CPU tests import
every module on machines with no CUDA toolkit.  A missing ``nvcc`` or a
failed build raises; nothing falls back to the plain versions.

:func:`register_op` makes a kernel wrapper a ``torch.library`` op of the
``transcar`` namespace, so that ``torch.export`` traces it and
``FlopCounterMode`` counts it.  It defines the op through
``torch.library.Library`` rather than ``torch.library.custom_op``, whose
Python dispatch layers cost a serving call several times as much host
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_functions: dict = {}
_ops_library = None         # the transcar op namespace (register_op)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           f"{CSRC} are built at first use and need the "
                           "CUDA toolkit")
    return nvcc


def library_path(csrc: pathlib.Path = CSRC,
                 build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where the library for the sources in ``csrc`` lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return build_dir / f"libtranscar_kernels_{digest.hexdigest()[:16]}.so"


def build(csrc: pathlib.Path = CSRC,
          build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) is kept beside the library as ``<name>.log``.
    Another ``csrc`` (an earlier commit's sources, to time its kernels
    beside these) builds the same way into its own ``build_dir``.
    """
    so = library_path(csrc, build_dir)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(csrc.glob("*.cu")):
        obj = build_dir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    tmp = so.with_name(f"{tag}.so.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, so)        # atomic: a concurrent build never sees half
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.tck_error_string.argtypes = [ctypes.c_int]
        lib.tck_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def function(name: str, *argtypes):
    """A C entry point of the library; every one returns a cudaError_t.
    Looked up and typed once per argument list, not at every launch."""
    key = (name, argtypes)
    fn = _functions.get(key)
    if fn is None:
        fn = library()[name]           # an object of its own per key
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch returned an error (e.g. a refused launch, which
    never runs and which a later synchronize would not report)."""
    if rc != 0:
        msg = library().tck_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def register_op(schema: str, cuda, cpu, fake):
    """Define ``transcar::<schema>`` with ``cuda`` (the kernel wrapper) and
    ``cpu`` (the plain version) as its implementations and ``fake`` as its
    shape function (the meta device's too); returns the op's default
    overload, ``torch.ops.transcar.<name>.default``.  The op has no
    autograd formula: the callers that need a gradient take the plain
    version or their autograd functions."""
    global _ops_library
    if _ops_library is None:
        _ops_library = torch.library.Library("transcar", "DEF")
    name = schema.split("(", 1)[0]
    _ops_library.define(schema)
    _ops_library.impl(name, cuda, "CUDA")
    _ops_library.impl(name, cpu, "CPU")
    torch.library.register_fake(f"transcar::{name}", fake, lib=_ops_library)
    return getattr(torch.ops.transcar, name).default
