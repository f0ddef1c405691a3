"""Build and load the CUDA kernels of ``ttipm_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library goes
to ``build/ttipm_kernels/`` at the repository root, named by a hash of the
sources and flags, so a rebuild happens only when a source changes.  The
build runs at the first kernel launch, never at import.  Every failure to
find ``nvcc``, compile or load raises ``KernelError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["KernelError", "load_library", "build_library", "error_string", "BUILD_DIR",
           "SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ttipm_kernels")
SOURCES = ("schur_assemble.cu", "kkt_matvec.cu", "panel_qr.cu", "panel_cholesky.cu")
_HEADERS = ("gemm_f64.cuh",)
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]

_LIB = None


class KernelError(RuntimeError):
    """A CUDA kernel could not be built, loaded, given its operands or
    launched.  The solver never recovers from it."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES + _HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build_library() -> str:
    """Compile the kernels if no library for the current sources exists;
    return its path.  The library is written under a temporary name and
    renamed, so concurrent builders never load a half-written file."""
    path = os.path.join(BUILD_DIR, f"libttipm_kernels_{_digest()}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_FLAGS, "-o", tmp] + [os.path.join(CSRC, s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_library()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "ttipm_schur_assemble": [p, p, p] + [i] * 7 + [p],
        "ttipm_kkt_matvec": [p] * 7 + [i] * 8 + [p],
        "ttipm_panel_qr": [p, p, p, i, i, p],
        "ttipm_panel_cholesky": [p, i, p, p],
        "ttipm_error_string": [i],
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_char_p if name == "ttipm_error_string" else ctypes.c_int
    _LIB = lib
    return lib


def error_string(err: int) -> str:
    return load_library().ttipm_error_string(int(err)).decode()
