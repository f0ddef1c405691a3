"""Build and load the CUDA kernels of ``ttipm_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one compiler process
per source, all started together) and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``.  Each kernel is a
template on its element type with a C entry point per instance: the f64 one
under the kernel's name, the f32 one with the suffix ``_f32`` (the two
Jacobi kernels have the f64 one only).  The library goes
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

__all__ = ["KernelError", "load_library", "build_library", "library_path", "error_string",
           "BUILD_DIR", "SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ttipm_kernels")
SOURCES = ("schur_assemble.cu", "kkt_matvec.cu", "panel_qr.cu", "panel_cholesky.cu",
           "jacobi_svd.cu", "jacobi_eigh.cu")
HEADERS = ("scalar.cuh", "jacobi.cuh")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]

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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Where the library of the current sources is (or will be) built."""
    return os.path.join(BUILD_DIR, f"libttipm_kernels_{_digest()}.so")


def build_library() -> str:
    """Compile the kernels if no library for the current sources exists;
    return its path.  The library is written under a temporary name and
    renamed, so concurrent builders never load a half-written file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [os.path.join(work, os.path.splitext(s)[0] + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", os.path.join(CSRC, s), "-o", o],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(SOURCES, objects)]
        failed = []
        for s, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{s}: nvcc failed ({proc.returncode}):\n{err}")
        if failed:
            raise KernelError("\n".join(failed))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([nvcc, *_FLAGS, "-shared", "-o", tmp, *objects],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
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
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    table = ctypes.c_char_p  # packed words, read on the host
    typed = {  # one entry per element type: name (f64), name + "_f32"
        "ttipm_schur_assemble": [table, table, i, i, p, i, i, i, p],
        "ttipm_kkt_product": [table, table, i, i, table, p, i, i, i, i, p],
        "ttipm_panel_qr": [p, ll, ll, ll, i, p, i, p, i, i, i, i, p, p],
        "ttipm_panel_cholesky": [p, ll, ll, ll, i, p, i, p, p, p],
        "ttipm_panel_cholesky_workspace": [i],
    }
    signatures = {
        **typed, **{name + "_f32": args for name, args in typed.items()},
        "ttipm_empty_launch": [p],
        "ttipm_panel_qr_stamps": [p, p, p, i, i, i, i, p, p, p],
        "ttipm_jacobi_svd": [p, i, i, f, f, p, p, p, p, i, i, i, p],      # float64 only
        "ttipm_jacobi_svd_stamps": [p, i, f, f, p, p, p, i, i, i, p, p],
        "ttipm_jacobi_eigh": [p, i, i, f, f, p, p, p, i, i, i, p],
        "ttipm_jacobi_eigh_stamps": [p, i, f, f, p, p, i, i, i, p, p],
        "ttipm_error_string": [i],
    }
    restypes = {"ttipm_error_string": ctypes.c_char_p, "ttipm_panel_cholesky_workspace": ll,
                "ttipm_panel_cholesky_workspace_f32": ll}
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = restypes.get(name, ctypes.c_int)
    _LIB = lib
    return lib


def error_string(err: int) -> str:
    return load_library().ttipm_error_string(int(err)).decode()
