"""Hand-written CUDA kernels of the fused KKT path, with their plain
PyTorch versions and launch counters.

Each of the four Pallas TPU kernels of ``ttipm_tpu/ops/kernels.py`` has a
counterpart here:

============================  =====================================  ===========================
wrapper                       replaces                               CUDA source
============================  =====================================  ===========================
``schur_assemble`` (K1)       ``schur_assemble`` / ``proj``          ``csrc/schur_assemble.cu``
``kkt_block_matvec`` (K2)     ``kkt_block_matvec`` / ``apply``       ``csrc/kkt_matvec.cu``
``panel_qr`` (K3)             ``panel_qr`` / ``qr_reduced``          ``csrc/panel_qr.cu``
``panel_cholesky`` (K4)       ``panel_cholesky`` / L_Z factor        ``csrc/panel_cholesky.cu``
============================  =====================================  ===========================

A wrapper given CPU tensors runs the plain version (einsum or
``torch.linalg``) and counts a plain call.  Given CUDA tensors it launches
its kernel and counts a launch, or raises ``KernelError``: it never falls
back and never catches a build or launch error.  The kernels take float64 only.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ttipm_tpu_torch.ops import _build
from ttipm_tpu_torch.ops._build import KernelError

__all__ = [
    "KernelError", "KernelStats", "STATS", "reset_counts",
    "schur_assemble", "schur_assemble_plain",
    "kkt_block_matvec", "kkt_block_matvec_plain",
    "panel_qr", "panel_qr_plain",
    "panel_cholesky", "panel_cholesky_plain",
]


class KernelStats:
    """Launch and plain-call counts of one kernel wrapper."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


STATS = {
    name: KernelStats(name)
    for name in ("schur_assemble", "kkt_block_matvec", "panel_qr", "panel_cholesky")
}


def reset_counts() -> None:
    for s in STATS.values():
        s.reset()


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU operands; raises otherwise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise KernelError(f"operands on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise KernelError(f"no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float64:
            raise KernelError(f"the CUDA kernels take float64, got {t.dtype}")
    return True


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(name: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err} ({_build.error_string(err)})")


def _lib():
    return _build.load_library()


# ---------------------------------------------------------------------------
# K1: Schur block assembly  B[(l,m,L),(r,n,R)] = phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R]
# ---------------------------------------------------------------------------

def schur_assemble_plain(phi_l, A, phi_r):
    rows = phi_l.shape[0] * A.shape[1] * phi_r.shape[0]
    cols = phi_l.shape[2] * A.shape[2] * phi_r.shape[2]
    return torch.einsum("lsr,smnS,LSR->lmLrnR", phi_l, A, phi_r).reshape(rows, cols)


def schur_assemble(phi_l, A, phi_r):
    """Dense projected block of one operator core as an (l*m*L) x (r*n*R)
    matrix (the fused local solves' ``proj``)."""
    stats = STATS["schur_assemble"]
    if not _on_cuda(phi_l, A, phi_r):
        stats.plain_calls += 1
        return schur_assemble_plain(phi_l, A, phi_r)
    l, s, r = phi_l.shape
    s2, m, n, S = A.shape
    L, S2, R = phi_r.shape
    if s2 != s or S2 != S:
        raise KernelError(f"schur_assemble: bond mismatch {phi_l.shape} {A.shape} {phi_r.shape}")
    # Stage 1 (the s-contraction) stays an einsum, as in the TPU kernel.
    W = torch.einsum("lsr,smnS->lmrnS", phi_l, A).contiguous()
    P = phi_r.permute(1, 0, 2).contiguous()  # (S, L, R)
    out = torch.empty((l * m * L, r * n * R), dtype=W.dtype, device=W.device)
    with torch.cuda.device(W.device):
        err = _lib().ttipm_schur_assemble(
            _ptr(W), _ptr(P), _ptr(out), l, m, r, n, S, L, R, _stream(W))
    _check("schur_assemble", err)
    stats.launches += 1
    return out


# ---------------------------------------------------------------------------
# K2: projected block matvec  y[l,m,L] = phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R] x[r,n,R]
# ---------------------------------------------------------------------------

def kkt_block_matvec_plain(phi_l, A, phi_r, x):
    return torch.einsum("lsr,smnS,LSR,rnR->lmL", phi_l, A, phi_r, x)


def kkt_block_matvec(phi_l, A, phi_r, x):
    """Apply one projected operator block to a local core (the fused
    algebra's ``apply``); ``apply_T`` is this call on transposed operands."""
    stats = STATS["kkt_block_matvec"]
    if not _on_cuda(phi_l, A, phi_r, x):
        stats.plain_calls += 1
        return kkt_block_matvec_plain(phi_l, A, phi_r, x)
    l, s, r = phi_l.shape
    s2, m, n, S = A.shape
    L, S2, R = phi_r.shape
    if s2 != s or S2 != S or tuple(x.shape) != (r, n, R):
        raise KernelError(
            f"kkt_block_matvec: shape mismatch {phi_l.shape} {A.shape} "
            f"{phi_r.shape} {x.shape}")
    phi_l = phi_l.contiguous()
    phi_r = phi_r.contiguous()
    x = x.contiguous()
    a2 = A.permute(1, 3, 0, 2).reshape(m * S, s * n).contiguous()
    t1 = torch.empty(s * n * l * R, dtype=x.dtype, device=x.device)
    t2 = torch.empty(l * m * S * R, dtype=x.dtype, device=x.device)
    y = torch.empty((l, m, L), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().ttipm_kkt_matvec(
            _ptr(phi_l), _ptr(a2), _ptr(phi_r), _ptr(x), _ptr(t1), _ptr(t2),
            _ptr(y), l, s, r, m, n, S, L, R, _stream(x))
    _check("kkt_block_matvec", err)
    stats.launches += 1
    return y


# ---------------------------------------------------------------------------
# K3: reduced Householder QR of a tall panel
# ---------------------------------------------------------------------------

def panel_qr_plain(a):
    return torch.linalg.qr(a, mode="reduced")


def panel_qr(a):
    """Reduced QR of a tall panel (m >= n): q (m, n) with orthonormal
    columns, r (n, n) upper triangular with exact zeros below the diagonal,
    q @ r == a; LAPACK's sign convention."""
    stats = STATS["panel_qr"]
    if not _on_cuda(a):
        stats.plain_calls += 1
        return panel_qr_plain(a)
    m, n = a.shape
    if m < n or n < 1:
        raise KernelError(f"panel_qr: needs a tall panel, got {tuple(a.shape)}")
    a = a.contiguous()
    q = torch.empty((m, n), dtype=a.dtype, device=a.device)
    r = torch.empty((n, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib().ttipm_panel_qr(_ptr(a), _ptr(q), _ptr(r), m, n, _stream(a))
    _check("panel_qr", err)
    stats.launches += 1
    return q, r


# ---------------------------------------------------------------------------
# K4: Cholesky with failure report (one launch up to order 512, blocked above)
# ---------------------------------------------------------------------------

def panel_cholesky_plain(a):
    return torch.linalg.cholesky_ex(a)


# Largest order the kernel factors in one launch, and the blocked regime's
# panel width (kResidentMaxN, kNB in csrc/panel_cholesky.cu); above the
# bound the kernel needs a workspace, whose size the library gives.
K4_RESIDENT_MAX_N = 512
K4_PANEL = 64


def panel_cholesky(a):
    """Lower Cholesky factor of a symmetric matrix (only its lower triangle
    is read).  Returns ``(L, info)`` like ``torch.linalg.cholesky_ex``:
    ``info`` is 0 on success, else the 1-based order of the first leading
    minor that is not positive definite (L is then unspecified).  No
    pivot is clamped.  Only a single square matrix is taken, on any
    device (``KernelError`` otherwise); the kernel reads any strides."""
    stats = STATS["panel_cholesky"]
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise KernelError(f"panel_cholesky: one square matrix expected, got {tuple(a.shape)}")
    if not _on_cuda(a):
        stats.plain_calls += 1
        return panel_cholesky_plain(a)
    n = a.shape[0]
    out = torch.empty((n, n), dtype=a.dtype, device=a.device)
    info = torch.empty((), dtype=torch.int32, device=a.device)
    ws = None
    if n > K4_RESIDENT_MAX_N:
        ws = torch.empty(_lib().ttipm_panel_cholesky_workspace(n), dtype=a.dtype,
                         device=a.device)
    # The small orders of the solve are bound by launch latency: take the
    # raw stream handle, and enter a device guard only when the operand is
    # not on the current device.
    dev = a.device.index
    stream = ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev))
    guard = (contextlib.nullcontext() if dev == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        err = _lib().ttipm_panel_cholesky(
            _ptr(a), a.stride(0), a.stride(1), _ptr(out), n, _ptr(info),
            ctypes.c_void_p(None if ws is None else ws.data_ptr()), stream)
    _check("panel_cholesky", err)
    stats.launches += 1
    return out, info
