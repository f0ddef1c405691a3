"""The roofline bound of each call of the program's six CUDA kernels.

Frozen with the benchmark: the operations and bytes of a call are counted
from its operands' shapes alone, by one rule per kernel that no choice of
the implementation can change, and the bound is the larger of bytes over
the memory rate and operations over the peak rate.  Every distinct input
is read once and every output written once.  A call with a leading batch
axis counts each instance.

J1 and J2 (the Jacobi SVD and eigh cores) count one sweep of element
rotations at every order: a Jacobi method makes at least one pass over
all pairs, to rotate or to find nothing left to rotate, so no Jacobi
kernel does less work than this and its share cannot pass 100%.  A
kernel that makes k sweeps on an operand reads about k times too low.

Peaks: one NVIDIA H100 SXM, dense, from NVIDIA's data sheet, at its full
power limit of 700 W: 67 TFLOP/s in float64 on the tensor cores and in
float32 outside them, 3.35 TB/s of HBM3.  Program names: the entry points
of ``ttipm_tpu_torch.ops.kernels`` and the CUDA kernels under its
``csrc/``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

__all__ = ["ENTRIES", "DEVICE_NAMES", "HBM_BYTES_PER_S", "FLOP_PER_S", "bound_s", "kernel_of"]

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float64": 67e12, "float32": 67e12}

# entry point -> the kernel it launches
ENTRIES = {
    "schur_assemble": "schur_assemble",
    "schur_assemble_group": "schur_assemble",
    "schur_assemble_batch": "schur_assemble",
    "kkt_block_matvec": "kkt_block_matvec",
    "kkt_block_product": "kkt_block_matvec",
    "kkt_block_product_batch": "kkt_block_matvec",
    "panel_qr": "panel_qr",
    "panel_qr_batch": "panel_qr",
    "panel_cholesky": "panel_cholesky",
    "panel_cholesky_batch": "panel_cholesky",
    "jacobi_orthogonalise": "jacobi_svd",
    "jacobi_eigh_core": "jacobi_eigh",
}

# kernel -> the names of its CUDA kernels, as the device trace shows them
DEVICE_NAMES = {
    "schur_assemble": ("schur_kernel",),
    "kkt_block_matvec": ("kkt_product_kernel",),
    "panel_qr": ("panel_qr_kernel",),
    "panel_cholesky": ("chol_resident_kernel", "chol_copy_kernel", "chol_blocked_kernel"),
    "jacobi_svd": ("jacobi_svd_kernel", "jacobi_svd_block_kernel"),
    "jacobi_eigh": ("jacobi_eigh_kernel", "jacobi_eigh_block_kernel"),
}


def kernel_of(device_name: str):
    """The kernel whose CUDA kernel ``device_name`` is, or None."""
    for kernel, names in DEVICE_NAMES.items():
        if any(n in device_name for n in names):
            return kernel
    return None


def _tensors(arg) -> Iterable:
    if hasattr(arg, "shape") and hasattr(arg, "element_size"):
        yield arg
    elif isinstance(arg, (list, tuple)):
        for a in arg:
            yield from _tensors(a)


def _bytes_in(args) -> Tuple[int, int, str]:
    """(bytes of the distinct inputs, element size, dtype name)."""
    seen, total, first = set(), 0, None
    for t in _tensors(args):
        first = first if first is not None else t
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            total += t.element_size() * t.numel()
    return total, first.element_size(), str(first.dtype).split(".")[-1]


def _k1(blocks, batch: bool) -> Tuple[int, int]:
    """(output elements, operations) of K1's dense projected blocks."""
    out = flops = 0
    for phi_l, A, phi_r in blocks:
        b = phi_l.shape[0] if batch else 1
        l, s, r = phi_l.shape[-3:]
        _, m, n, S = A.shape[-4:]
        L, _, R = phi_r.shape[-3:]
        out += b * l * m * L * r * n * R
        flops += b * 2 * l * m * r * n * S * (s + L * R)
    return out, flops


def _k2(terms, nrows: int, batch: bool) -> Tuple[int, int]:
    """(output elements, operations) of K2's projected block products."""
    flops, first = 0, terms[0]
    b = first[0].shape[0] if batch else 1
    for phi_l, A, phi_r, x, *_ in terms:
        l, s, r = phi_l.shape[-3:]
        _, m, n, S = A.shape[-4:]
        L, _, R = phi_r.shape[-3:]
        flops += b * 2 * (l * s * r * n * R + m * S * s * n * l * R + l * m * S * R * L)
    l, m, L = first[0].shape[-3], first[1].shape[-3], first[2].shape[-3]
    return b * l * nrows * m * L, flops


def _rule(entry: str, args, kwargs) -> Tuple[int, int]:
    """(output elements, operations) of one call of ``entry``."""
    if entry == "schur_assemble":
        return _k1([args], False)
    if entry == "schur_assemble_group":
        return _k1(args[0], False)
    if entry == "schur_assemble_batch":
        return _k1(args[0], True)
    if entry == "kkt_block_matvec":
        return _k2([args], 1, False)
    if entry in ("kkt_block_product", "kkt_block_product_batch"):
        return _k2(args[0], args[1], entry.endswith("_batch"))
    a = args[0]
    b = a.shape[0] if a.dim() == 3 else 1
    if entry in ("panel_qr", "panel_qr_batch"):
        m, n = a.shape[-2:]
        return b * (m * n + n * n), b * (4 * m * n * n - 4 * n**3 // 3)
    if entry in ("panel_cholesky", "panel_cholesky_batch"):
        n = a.shape[-1]
        return b * n * n, b * (n**3 // 3)
    if entry == "jacobi_orthogonalise":
        n = a.shape[-1]  # one sweep: n(n-1)/2 rotations of W's and V's columns
        return b * (2 * n * n + n), b * (9 * n * n * (n - 1) + n**3)
    if entry == "jacobi_eigh_core":
        n = a.shape[-1]
        vectors = kwargs.get("vectors", args[1] if len(args) > 1 else True)
        if vectors:  # one sweep: rotations of A's rows and columns and of V's columns
            return b * (n * n + n), b * (9 * n * n * (n - 1) + 3 * n * n)
        return b * n, b * 6 * n * n * (n - 1)
    raise KeyError(entry)


def bound_s(entry: str, args, kwargs: Dict) -> float:
    """Roofline bound, in seconds, of one call of kernel entry ``entry``."""
    bytes_in, esize, dtype = _bytes_in(args)
    out, flops = _rule(entry, args, kwargs)
    return max((bytes_in + esize * out) / HBM_BYTES_PER_S, flops / FLOP_PER_S[dtype])
