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

and two kernels that replace no Pallas kernel but the JAX package's jnp
Jacobi programs (``ttipm_tpu/ops/jacobi.py``), the cores of the port's SVD
and ``eigh`` on the card (the pipelines around them: ``ops/jacobi.py``):

==================================  =================================  ===========================
wrapper                             replaces (jnp, not Pallas)         CUDA source
==================================  =================================  ===========================
``jacobi_orthogonalise`` (J1)       ``_jacobi_orthogonalise`` ``:121`` ``csrc/jacobi_svd.cu``
``jacobi_eigh_core`` (J2)           ``_jacobi_eigh_core`` ``:370``     ``csrc/jacobi_eigh.cu``
==================================  =================================  ===========================

J1 and J2 take float64 only (f32 factorizations are upcast before them)
and a leading batch axis always; their counters are ``STATS["jacobi_svd"]``
and ``STATS["jacobi_eigh"]``, whose ``outside`` counts the factorizations
that the pipelines' shape rules sent to ``torch.linalg`` (K3's counts the
pipelines' QRs outside its envelope).

K1 and K2 also have grouped entry points over the same kernels:
``schur_assemble_group`` (several blocks of equal size, one launch) and
``kkt_block_product`` (all terms of a block product, one launch).

Every kernel also takes a batch: ``schur_assemble_batch``,
``kkt_block_product_batch``, ``panel_qr_batch`` and
``panel_cholesky_batch`` take operands with a leading batch axis of B
structurally identical instances (the lockstep batched solve of
``parallel/fused_mesh.py``) and make one call for all of them.  The batch
index is a grid axis of the launch; only K4's blocked regime (order above
512) launches once per instance inside the call, and K3's cluster regime
runs one cluster an instance.  An instance is computed by the code and in
the order of a single call on it, so on the card instance i of a batch
equals the single call on instance i bit for bit.

A wrapper given CPU tensors runs the plain version (einsum or
``torch.linalg``) and counts a plain call.  Given CUDA tensors it launches
its kernel and counts a launch, or raises ``KernelError``: it never falls
back and never catches a build or launch error.

Every kernel has a float64 and a float32 instance (the f64 and the f32
profile; the TPU ran its Pallas kernels in f32).  A wrapper takes operands
of one of these two types, all of the same type, and launches the instance
of that type; any other type, or operands of mixed types, raise
``KernelError`` on every device.  No wrapper changes an operand's type:
where the solver wants f64 arithmetic on f32 data (the mixed-precision
local solves) it casts before the call.  ``STATS[...].by_dtype`` counts the
launches of each instance.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import struct

import torch

from ttipm_tpu_torch.ops import _build
from ttipm_tpu_torch.ops._build import KernelError

__all__ = [
    "KernelError", "KernelStats", "STATS", "DTYPES", "ELEMENT_BYTES", "reset_counts",
    "counts_snapshot", "counts_delta", "add_counts",
    "schur_assemble", "schur_assemble_plain",
    "schur_assemble_group", "schur_assemble_group_plain",
    "kkt_block_matvec", "kkt_block_matvec_plain",
    "kkt_block_product", "kkt_block_product_plain",
    "k1_tiles", "k2_tiles", "pack_k1_blocks", "pack_k2_terms", "empty_launch",
    "panel_qr", "panel_qr_plain", "k3_plan",
    "panel_cholesky", "panel_cholesky_plain",
    "schur_assemble_batch", "schur_assemble_batch_plain",
    "kkt_block_product_batch", "kkt_block_product_batch_plain",
    "panel_qr_batch", "panel_qr_batch_plain",
    "panel_cholesky_batch", "panel_cholesky_batch_plain",
    "jacobi_orthogonalise", "jacobi_orthogonalise_plain", "j1_plan", "J1_MAX_N",
    "jacobi_eigh_core", "jacobi_eigh_core_plain", "j2_plan", "J2_MAX_N", "J2_BLOCK",
    "J2_BLOCK_FROM", "jacobi_sweeps", "jacobi_eigh_stamps", "J2_STAMPS",
]


# The element types the kernels are instantiated for, by the name the
# counters and the C entry points use ("f32" adds the suffix "_f32").
DTYPES = {torch.float64: "f64", torch.float32: "f32"}
ELEMENT_BYTES = {"f64": 8, "f32": 4}


class KernelStats:
    """Counts of one kernel: device launches (a grouped or a batched call is
    one), how many of them came through the grouped entry point, how many
    through a batched one and the instances those carried, the launches and
    the instances of each type (``by_dtype``, ``instances_by_dtype``: "f64",
    "f32"), plain calls, the calls a shape rule sent to ``torch.linalg``
    instead (``outside``: the Jacobi pipelines' envelope), and the Jacobi
    kernels' launches by regime (``by_regime``: "element", "block")."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.grouped = 0
        self.batched = 0
        self.instances = 0
        self.plain_calls = 0
        self.outside = 0
        self.by_dtype = dict.fromkeys(DTYPES.values(), 0)
        self.instances_by_dtype = dict.fromkeys(DTYPES.values(), 0)
        self.by_regime = {"element": 0, "block": 0}

    def count(self, tag: str, grouped: bool = False, batch: int = 0) -> None:
        """One device launch of the ``tag`` instance; ``batch`` > 0: a
        batched launch of that many instances."""
        self.launches += 1
        self.grouped += int(grouped)
        self.batched += int(batch > 0)
        self.instances += batch
        self.by_dtype[tag] += 1
        self.instances_by_dtype[tag] += batch

    def snapshot(self) -> dict:
        """Every counter set by ``reset``, as plain numbers (its tables
        copied)."""
        return {f: dict(v) if isinstance(v, dict) else v
                for f, v in vars(self).items() if f != "name"}

    def add(self, delta: dict, times: int = 1) -> None:
        """Add ``times`` times ``delta`` (a difference of two snapshots)
        to the counters."""
        for f, d in delta.items():
            if isinstance(d, dict):
                table = getattr(self, f)
                for k, v in d.items():
                    table[k] += times * v
            else:
                setattr(self, f, getattr(self, f) + times * d)


STATS = {
    name: KernelStats(name)
    for name in ("schur_assemble", "kkt_block_matvec", "panel_qr", "panel_cholesky",
                 "jacobi_svd", "jacobi_eigh")
}


def reset_counts() -> None:
    for s in STATS.values():
        s.reset()


def counts_snapshot() -> dict:
    """Every kernel's counters (``KernelStats.snapshot``), by name."""
    return {name: s.snapshot() for name, s in STATS.items()}


def counts_delta(before: dict, after: dict) -> dict:
    """What every kernel's counters moved from one ``counts_snapshot`` to
    a later one."""
    def diff(a, b):
        return {k: v - b[k] for k, v in a.items()} if isinstance(a, dict) else a - b

    return {name: {f: diff(v, before[name][f]) for f, v in a.items()}
            for name, a in after.items()}


def add_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` times a ``counts_delta`` to ``STATS`` (a CUDA graph's
    replay: the launches its capture counted, made again on the card)."""
    for name, d in delta.items():
        STATS[name].add(d, times)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU operands; raises for any other
    device, for operands on different devices, and for operands that are
    not all float64 or all float32."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise KernelError(f"operands on different devices: {dev} and {t.device}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise KernelError(f"operands of mixed types {sorted(map(str, dtypes))}: the kernels "
                          "take float64 or float32 operands, all of one type")
    if tensors[0].dtype not in DTYPES:
        raise KernelError(f"no kernel for {tensors[0].dtype}: the kernels take float64 or "
                          "float32")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise KernelError(f"no kernel for device {dev}")
    return True


def _tag(t: torch.Tensor) -> str:
    """"f64" or "f32": the instance for operands of ``t``'s type."""
    return DTYPES[t.dtype]


def _entry(name: str, tag: str):
    """The C entry point of kernel ``name`` for the ``tag`` instance."""
    return getattr(_lib(), name if tag == "f64" else name + "_f32")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _opt_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


_NO_GUARD = contextlib.nullcontext()


def _launch_env(t: torch.Tensor):
    """(stream, guard) for a launch on ``t``'s device.  The small calls of
    the solve are bound by launch latency: take the raw handle of the
    current stream, and enter a device guard only when the operand is not
    on the current device."""
    dev = t.device.index
    stream = ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev))
    guard = _NO_GUARD if dev == torch.cuda.current_device() else torch.cuda.device(dev)
    return stream, guard


def _check(name: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err} ({_build.error_string(err)})")


def _lib():
    return _build.load_library()


def empty_launch(device) -> None:
    """Launch an empty kernel through the wrappers' ctypes path: the floor
    of a single call's time on the card."""
    stream, guard = _launch_env(torch.empty(0, device=device))
    with guard:
        _check("empty_launch", _lib().ttipm_empty_launch(stream))


# Dynamic shared memory a CTA may use on sm_90 (227 KB).
SMEM_LIMIT = 232448
# CTAs a launch should reach where the shapes allow it (the card's SMs).
_TARGET_CTAS = 132


# ---------------------------------------------------------------------------
# K1: Schur block assembly  B[(l,m,L),(r,n,R)] = phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R]
# ---------------------------------------------------------------------------

K1_MAX_BLOCKS = 8
_K1_TN, _K1_KS = 64, 32  # kTN, kKS in csrc/schur_assemble.cu


def schur_assemble_plain(phi_l, A, phi_r):
    rows = phi_l.shape[0] * A.shape[1] * phi_r.shape[0]
    cols = phi_l.shape[2] * A.shape[2] * phi_r.shape[2]
    return torch.einsum("lsr,smnS,LSR->lmLrnR", phi_l, A, phi_r).reshape(rows, cols)


def schur_assemble_group_plain(blocks):
    return [schur_assemble_plain(*b) for b in blocks]


def _dims(name, ops):
    """(l, s, r, m, n, S, L, R) of ``(phi_l, A, phi_r[, x, ...])``, the
    bonds checked, and the shape of x where there is one."""
    try:
        l, s, r = ops[0].shape
        s2, m, n, S = ops[1].shape
        L, S2, R = ops[2].shape
    except (ValueError, IndexError):
        raise KernelError(f"{name}: operands are (phi_l[l,s,r], A[s,m,n,S], phi_r[L,S,R]"
                          "[, x[r,n,R]])") from None
    if (s2 != s or S2 != S or 0 in (l, s, r, m, n, S, L, R)
            or (len(ops) > 3 and ops[3].shape != (r, n, R))):
        raise KernelError(f"{name}: shape mismatch {[tuple(t.shape) for t in ops[:4]]}")
    return l, s, r, m, n, S, L, R


@functools.lru_cache(maxsize=4096)
def k1_tiles(dims, esize=8, batch=1):
    """Row tile, resident chunk of S and column split of one K1 launch,
    from the tuple of the blocks' ``(l, s, r, m, n, S, L, R)``, the
    element size in bytes (8 for the f64 instance, 4 for f32) and the
    instances of a batch: the largest row tile of 64, 32, 16 that still
    gives the card a CTA per SM, all of S resident where the W slice fits
    in shared memory beside the staged slice of phi_r, and the column tiles
    of a row tile shared between CTAs only while the grid is short of the
    target.  None of the three changes the order of an element's sums."""
    rows = max(l * m * r * n for l, s, r, m, n, S, L, R in dims)
    col_tiles = max(-(-(L * R) // _K1_TN) for l, s, r, m, n, S, L, R in dims)
    s_max = max(d[5] for d in dims)
    g = len(dims) * batch
    tm = next((t for t in (64, 32) if g * -(-rows // t) >= _TARGET_CTAS), 16)
    ctas = g * -(-rows // tm)
    colsplit = min(col_tiles, max(1, -(-_TARGET_CTAS // ctas)))
    cap = (SMEM_LIMIT // esize - _K1_KS * (_K1_TN + 1)) // tm  # leading dimension of Ws
    sc = min(s_max, cap if cap % 2 else cap - 1)
    return tm, sc, colsplit


def pack_k1_blocks(blocks, dims):
    """The kernel's table of blocks as a flat list of 64-bit words, 21 per
    block: three addresses, l s r m n S L R, the element strides of phi_l,
    A and phi_r."""
    words = []
    for (phi_l, A, phi_r), d in zip(blocks, dims):
        words += (phi_l.data_ptr(), A.data_ptr(), phi_r.data_ptr(), *d,
                  *phi_l.stride(), *A.stride(), *phi_r.stride())
    return words


def _k1_check(blocks):
    """Dims of the blocks of one launch; they share the output size."""
    if not 0 < len(blocks) <= K1_MAX_BLOCKS:
        raise KernelError(f"schur_assemble: 1 to {K1_MAX_BLOCKS} blocks a launch, "
                          f"got {len(blocks)}")
    dims = tuple(_dims("schur_assemble", b) for b in blocks)
    sizes = {(l * m * L, r * n * R) for l, s, r, m, n, S, L, R in dims}
    if len(sizes) != 1:
        raise KernelError(f"schur_assemble: blocks of unequal output size {sorted(sizes)}")
    return dims


def _k1_launch(blocks, dims, batch=0):
    """Blocks of equal output size through one launch; a (g, M, N) tensor,
    or with ``batch`` instances (operands (B, ...)) a (g, B, M, N) one."""
    l, _, r, m, n, _, L, R = dims[0]
    ref = blocks[0][0]
    nb = max(batch, 1)
    out = torch.empty((len(blocks), nb, l * m * L, r * n * R), dtype=ref.dtype,
                      device=ref.device)
    one = [tuple(t[0] for t in b) for b in blocks] if batch else blocks
    words = pack_k1_blocks(one, dims)
    table = struct.pack(f"{len(words)}q", *words)
    bstrides = None
    if batch:
        bw = [t.stride(0) for b in blocks for t in b]
        bstrides = struct.pack(f"{len(bw)}q", *bw)
    tag = _tag(ref)
    tm, sc, colsplit = k1_tiles(dims, ELEMENT_BYTES[tag], nb)
    stream, guard = _launch_env(ref)
    with guard:
        err = _entry("ttipm_schur_assemble", tag)(table, bstrides, len(blocks), nb, _ptr(out),
                                                    tm, sc, colsplit, stream)
    _check("schur_assemble", err)
    return out if batch else out[:, 0]


def schur_assemble_group(blocks):
    """Dense projected blocks of several operator cores, each an
    (l*m*L) x (r*n*R) matrix of the same size, from one launch:
    ``blocks`` is a list of ``(phi_l, A, phi_r)``; operator ranks may
    differ between blocks.  Returns a list of views of one allocation."""
    stats = STATS["schur_assemble"]
    blocks = [tuple(b) for b in blocks]
    dims = _k1_check(blocks)
    if not _on_cuda(*(t for b in blocks for t in b)):
        stats.plain_calls += 1
        return schur_assemble_group_plain(blocks)
    out = list(_k1_launch(blocks, dims).unbind(0))
    stats.count(_tag(blocks[0][0]), grouped=True)
    return out


def schur_assemble(phi_l, A, phi_r):
    """Dense projected block of one operator core as an (l*m*L) x (r*n*R)
    matrix (the fused local solves' ``proj``)."""
    stats = STATS["schur_assemble"]
    if not _on_cuda(phi_l, A, phi_r):
        stats.plain_calls += 1
        return schur_assemble_plain(phi_l, A, phi_r)
    blocks = [(phi_l, A, phi_r)]
    out = _k1_launch(blocks, _k1_check(blocks))[0]
    stats.count(_tag(phi_l))
    return out


# ---------------------------------------------------------------------------
# K2: projected block product, per term
#     y[l,m,L] = phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R] x[r,n,R]
# ---------------------------------------------------------------------------

K2_MAX_TERMS = 12  # kMaxTerms in csrc/kkt_matvec.cu


def kkt_block_matvec_plain(phi_l, A, phi_r, x):
    return torch.einsum("lsr,smnS,LSR,rnR->lmL", phi_l, A, phi_r, x)


def kkt_block_product_plain(terms, nrows):
    """Row ``i`` of the result is the sum of the block matvecs of the terms
    ``(phi_l, A, phi_r, x, row)`` with ``row == i``; (l, nrows, m, L)."""
    rows = [None] * nrows
    for phi_l, A, phi_r, x, row in terms:
        y = kkt_block_matvec_plain(phi_l, A, phi_r, x)
        rows[row] = y if rows[row] is None else rows[row] + y
    ref = next(r for r in rows if r is not None)
    return torch.stack([torch.zeros_like(ref) if r is None else r for r in rows], dim=1)


@functools.lru_cache(maxsize=4096)
def k2_tiles(dims, nrows, esize=8, batch=1):
    """The launch plan of one K2 launch, from the tuple of the terms'
    ``(l, s, r, m, n, S, L, R)``, the element size in bytes (8 for the
    f64 instance, 4 for f32) and the instances of a batch (which share the
    card's CTAs): ``(lc, rt, threads, smem_bytes, cap1, cap2, cap_phl,
    cap_x, cap_a, cap_phr)``, the ``Plan`` of ``csrc/kkt_matvec.cu``.

    A CTA owns ``lc`` values of l and walks over tiles of ``rt`` values of
    R.  It holds, in elements, ``2 lc m L`` (the row's sum and the running
    term) and, sized by its widest term, ``t1 = s n lc rt`` and
    ``t2 = lc m (S rt | 1)``.  R stays whole while one value of l fits
    (then the stages sum exactly as three chained GEMMs); otherwise it is
    cut into the fewest equal tiles that fit.  The chunk of l is the
    smallest that still leaves a CTA per SM, so the short dependent stages
    of a small product spread over the card.  What shared memory is left
    goes to staged copies of the CTA's slices of phi_r, A, x and phi_l, in
    that order (the longest chains first); a cap of 0 leaves an operand in
    device memory.  A CTA has 256 threads, 512 where a stage has more
    outputs than that."""
    l, _, _, m, _, _, L, _ = dims[0]

    def need(lc, rt):
        t1 = max(s * n * lc * min(rt, R) for _, s, _, _, n, _, _, R in dims)
        t2 = max(lc * m_ * ((S * min(rt, R)) | 1) for _, _, _, m_, _, S, _, R in dims)
        return t1, t2, 2 * lc * m * L + t1 + t2

    limit = SMEM_LIMIT // esize
    r_max = max(d[7] for d in dims)
    rt = r_max
    tiles = 1
    while need(1, rt)[2] > limit:
        if rt == 1:
            raise KernelError(f"kkt_block_matvec: operator ranks too large for one CTA: {dims}")
        tiles += 1
        rt = -(-r_max // tiles)
    lc = 1
    if rt == r_max:
        chunks = max(1, min(l, _TARGET_CTAS // (nrows * batch)))
        lc = -(-l // chunks)
        while need(lc, rt)[2] > limit:
            lc -= 1
    cap1, cap2, used = need(lc, rt)
    staged = (
        max(S * min(rt, R) * (L | 1) for _, _, _, _, _, S, _, R in dims),   # phi_r
        max(s * m_ * n * S for _, s, _, m_, n, S, _, _ in dims),            # A
        max(r * n * min(rt, R) for _, _, r, _, n, _, _, R in dims),         # x
        max(lc * s * r for _, s, r, _, _, _, _, _ in dims),                 # phi_l
    )
    caps = []
    for size in staged:
        caps.append(size if used + size <= limit else 0)
        used += caps[-1]
    cap_phr, cap_a, cap_x, cap_phl = caps
    threads = 512 if max(cap1, cap2) > 256 else 256
    return lc, rt, threads, esize * used, cap1, cap2, cap_phl, cap_x, cap_a, cap_phr


def pack_k2_terms(terms, dims):
    """The kernel's term table as a flat list of 64-bit words, 26 per term:
    four addresses, l s r m n S L R, the element strides of phi_l, A,
    phi_r and x, and the output row."""
    words = []
    for (phi_l, A, phi_r, x, row), d in zip(terms, dims):
        words += (phi_l.data_ptr(), A.data_ptr(), phi_r.data_ptr(), x.data_ptr(), *d,
                  *phi_l.stride(), *A.stride(), *phi_r.stride(), *x.stride(), row)
    return words


def _k2_check(terms, nrows):
    """Dims of the terms of one product; they share l, m, L and name rows
    below ``nrows``."""
    if not 0 < len(terms) <= K2_MAX_TERMS:
        raise KernelError(f"kkt_block_product: 1 to {K2_MAX_TERMS} terms a launch, "
                          f"got {len(terms)}")
    dims = tuple(_dims("kkt_block_matvec", t) for t in terms)
    l, _, _, m, _, _, L, _ = dims[0]
    for t, d in zip(terms, dims):
        if (d[0], d[3], d[6]) != (l, m, L) or not 0 <= t[4] < nrows:
            raise KernelError(f"kkt_block_product: term of output shape ({d[0]}, {d[3]}, "
                              f"{d[6]}), row {t[4]} in a product of ({l}, {nrows}, {m}, {L})")
    return dims


def _k2_launch(terms, nrows, dims, batch=0):
    """The terms through one launch; an (l, nrows, m, L) tensor, or with
    ``batch`` instances (operands (B, ...)) a (B, l, nrows, m, L) one."""
    l, _, _, m, _, _, L, _ = dims[0]
    x = terms[0][3]
    nb = max(batch, 1)
    out = torch.empty((nb, l, nrows, m, L), dtype=x.dtype, device=x.device)
    one = [(*(t[0] for t in term[:4]), term[4]) for term in terms] if batch else terms
    words = pack_k2_terms(one, dims)
    table = struct.pack(f"{len(words)}q", *words)
    bstrides = None
    if batch:
        bw = [t.stride(0) for term in terms for t in term[:4]]
        bstrides = struct.pack(f"{len(bw)}q", *bw)
    tag = _tag(x)
    plan = struct.pack("10i", *k2_tiles(dims, nrows, ELEMENT_BYTES[tag], nb))
    stream, guard = _launch_env(x)
    with guard:
        err = _entry("ttipm_kkt_product", tag)(table, bstrides, len(terms), nb, plan, _ptr(out),
                                                 l, m, L, nrows, stream)
    _check("kkt_block_matvec", err)
    return out if batch else out[0]


def kkt_block_product(terms, nrows):
    """A whole projected block product from one launch.  ``terms`` is a
    list of ``(phi_l, A, phi_r, x, row)``; row ``i`` of the (l, nrows, m, L)
    result is the sum over the terms of that row of the block matvec
    ``phi_l[l,s,r] A[s,m,n,S] phi_r[L,S,R] x[r,n,R]``.  Operands are read
    through their strides (no copies); bond and operator ranks may differ
    between terms, l, m and L may not."""
    stats = STATS["kkt_block_matvec"]
    terms = [tuple(t) for t in terms]
    dims = _k2_check(terms, nrows)
    if not _on_cuda(*(t for term in terms for t in term[:4])):
        stats.plain_calls += 1
        return kkt_block_product_plain(terms, nrows)
    out = _k2_launch(terms, nrows, dims)
    stats.count(_tag(terms[0][3]), grouped=True)
    return out


def kkt_block_matvec(phi_l, A, phi_r, x):
    """Apply one projected operator block to a local core (the fused
    algebra's ``apply``); ``apply_T`` is this call on transposed operands.
    The one-term case of ``kkt_block_product``."""
    stats = STATS["kkt_block_matvec"]
    if not _on_cuda(phi_l, A, phi_r, x):
        stats.plain_calls += 1
        return kkt_block_matvec_plain(phi_l, A, phi_r, x)
    terms = [(phi_l, A, phi_r, x, 0)]
    out = _k2_launch(terms, 1, _k2_check(terms, 1))[:, 0]
    stats.count(_tag(x))
    return out


# ---------------------------------------------------------------------------
# K3: reduced Householder QR of a tall panel
# ---------------------------------------------------------------------------

# The envelope (that of the reference's kernel) and the launch limits: kMaxM,
# kMaxN, kMaxCtas, kMaxThreads, kScalarRows in csrc/panel_qr.cu.
K3_MAX_M = 512
K3_MAX_N = 128
K3_MAX_CTAS = 4
K3_MAX_THREADS = 1024          # kMaxThreads: of a CTA in a cluster
K3_ONE_CTA_THREADS = 512       # kMaxThreadsOneCta: of the one CTA
_K3_SCALAR_ROWS = 3
# Rows of one CTA (kMaxSlabRows): a lane keeps its rows, at most 6, in
# registers; taller panels are cut into row slabs over a cluster.
K3_SLAB_ROWS = 192


def panel_qr_plain(a, transposed=False):
    q, r = torch.linalg.qr(a, mode="reduced")
    return (q.T.contiguous() if transposed else q), r


def _k3_smem(rows, n, esize=8):
    """Bytes of shared memory of a CTA that holds ``rows`` rows of the
    panel: column-major with an odd leading dimension, then tau, scale and
    beta, in elements of ``esize`` bytes."""
    return esize * ((rows | 1) * n + _K3_SCALAR_ROWS * n)


@functools.lru_cache(maxsize=4096)
def k3_plan(m, n, esize=8):
    """The launch plan of K3 for an (m, n) panel of elements of ``esize``
    bytes (8 for the f64 instance, 4 for f32): ``(ctas, threads,
    ws_elems, smem_bytes)``.  The slab height is set by the registers a
    lane holds its rows in, not by shared memory, so both instances take
    the same CTAs and threads; the f32 one uses half the bytes.  One CTA up to 192 rows (every panel of the
    solve), else a cluster of 2 or 4 CTAs with row slabs of at most 192
    rows and a workspace for the exchange of the per-column partial sums.
    One warp per column, a warp owning the columns c = w (mod W): up to 16
    warps in one CTA (its kernels are compiled for 512 threads, 128
    registers each; on an H100 128 x 34 takes 67 us of device time with 16
    warps, 80 with 8), up to 32 in a cluster (512 x 128: 1.05 ms against
    1.18 with 16).  Raises ``KernelError`` on shape
    alone outside n <= m <= 512, n <= 128."""
    if n < 1 or m < n:
        raise KernelError(f"panel_qr: needs a tall panel, got {(m, n)}")
    if m > K3_MAX_M or n > K3_MAX_N:
        raise KernelError(f"panel_qr: the kernel factors panels up to {K3_MAX_M} x {K3_MAX_N}, "
                          f"got {(m, n)}")
    ctas = next(c for c in (1, 2, K3_MAX_CTAS) if -(-m // c) <= K3_SLAB_ROWS)
    threads = 32 * min(n, (K3_ONE_CTA_THREADS if ctas == 1 else K3_MAX_THREADS) // 32)
    ws_elems = 0 if ctas == 1 else 2 * (ctas + 1) * n + 3 * ctas  # csrc/panel_qr.cu::ws_elems
    return ctas, threads, ws_elems, _k3_smem(-(-m // ctas), n, esize)


def panel_qr(a, transposed=False):
    """Reduced Householder QR of a tall panel (n <= m <= 512, n <= 128, any
    strides): q (m, n) with orthonormal columns, r (n, n) upper triangular
    with exact zeros below the diagonal, q @ r == a; LAPACK's sign
    convention.  With ``transposed`` the first result is q^T as a
    contiguous (n, m) array (what the backward split step reshapes)."""
    stats = STATS["panel_qr"]
    if a.dim() != 2:
        raise KernelError(f"panel_qr: one panel expected, got {tuple(a.shape)}")
    if not _on_cuda(a):
        stats.plain_calls += 1
        return panel_qr_plain(a, transposed)
    q, r = _k3_launch(a.unsqueeze(0), transposed)
    stats.count(_tag(a))
    return q[0], r[0]


def _k3_launch(a, transposed):
    """The panels of ``a`` (B, m, n) through one launch: q (B, m, n) or,
    with ``transposed``, (B, n, m), and r (B, n, n), each contiguous; the
    workspace of the cluster regime after them, a slice an instance."""
    nb, m, n = a.shape
    tag = _tag(a)
    esize = ELEMENT_BYTES[tag]
    ctas, threads, ws_elems, _ = k3_plan(m, n, esize)
    buf = torch.empty(nb * (m * n + n * n + ws_elems), dtype=a.dtype, device=a.device)
    q = buf[:nb * m * n].view((nb, n, m) if transposed else (nb, m, n))
    r = buf[nb * m * n:nb * (m * n + n * n)].view(nb, n, n)
    ws = ctypes.c_void_p(buf.data_ptr() + esize * nb * (m * n + n * n) if ws_elems else None)
    stream, guard = _launch_env(a)
    with guard:
        err = _entry("ttipm_panel_qr", tag)(_ptr(a), a.stride(1), a.stride(2), a.stride(0), nb,
                                            _ptr(q), int(transposed), _ptr(r), m, n, ctas,
                                            threads, ws, stream)
    _check("panel_qr", err)
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
    out, info = _k4_launch(a.unsqueeze(0))
    stats.count(_tag(a))
    return out[0], info[0]


def _k4_launch(a):
    """The matrices of ``a`` (B, n, n) through one call: L (B, n, n)
    contiguous and info (B,) int32; the blocked regime's workspace a slice
    an instance."""
    nb, n, _ = a.shape
    tag = _tag(a)
    out = torch.empty((nb, n, n), dtype=a.dtype, device=a.device)
    info = torch.empty((nb,), dtype=torch.int32, device=a.device)
    ws = None
    if n > K4_RESIDENT_MAX_N:
        ws = torch.empty(nb * _entry("ttipm_panel_cholesky_workspace", tag)(n), dtype=a.dtype,
                         device=a.device)
    stream, guard = _launch_env(a)
    with guard:
        err = _entry("ttipm_panel_cholesky", tag)(
            _ptr(a), a.stride(1), a.stride(2), a.stride(0), nb, _ptr(out), n,
            _ptr(info), ctypes.c_void_p(None if ws is None else ws.data_ptr()), stream)
    _check("panel_cholesky", err)
    return out, info


# ---------------------------------------------------------------------------
# Batches: B structurally identical instances, one call (the lockstep
# batched solve).  Every operand carries a leading batch axis of the same
# length; within an instance the shapes and rules of the single entry.
# ---------------------------------------------------------------------------

def _batch_len(name, tensors, ndims):
    """The common batch length of ``tensors``, each with a leading batch
    axis before its ``ndims`` instance axes."""
    lens = set()
    for t, nd in zip(tensors, ndims):
        if t.dim() != nd + 1:
            raise KernelError(f"{name}: operands with a leading batch axis expected, got "
                              f"{[tuple(x.shape) for x in tensors]}")
        lens.add(t.shape[0])
    if len(lens) != 1 or 0 in lens:
        raise KernelError(f"{name}: operands of unequal or empty batches {sorted(lens)}")
    return lens.pop()


def schur_assemble_batch_plain(blocks):
    out = []
    for phi_l, A, phi_r in blocks:
        B, l, _, r = phi_l.shape
        _, _, m, n, _ = A.shape
        _, L, _, R = phi_r.shape
        out.append(torch.einsum("blsr,bsmnS,bLSR->blmLrnR", phi_l, A, phi_r)
                   .reshape(B, l * m * L, r * n * R))
    return torch.stack(out)


def schur_assemble_batch(blocks):
    """``schur_assemble_group`` for a batch: ``blocks`` is a list of
    ``(phi_l, A, phi_r)`` of shapes (B, l, s, r), (B, s, m, n, S),
    (B, L, S, R); returns the (g, B, M, N) tensor of the g blocks of every
    instance, from one launch."""
    stats = STATS["schur_assemble"]
    blocks = [tuple(b) for b in blocks]
    tensors = [t for b in blocks for t in b]
    B = _batch_len("schur_assemble", tensors, [3, 4, 3] * len(blocks))
    dims = _k1_check([tuple(t[0] for t in b) for b in blocks])
    if not _on_cuda(*tensors):
        stats.plain_calls += 1
        return schur_assemble_batch_plain(blocks)
    out = _k1_launch(blocks, dims, B)
    stats.count(_tag(blocks[0][0]), grouped=True, batch=B)
    return out


def kkt_block_product_batch_plain(terms, nrows):
    rows = [None] * nrows
    for phi_l, A, phi_r, x, row in terms:
        y = torch.einsum("blsr,bsmnS,bLSR,brnR->blmL", phi_l, A, phi_r, x)
        rows[row] = y if rows[row] is None else rows[row] + y
    ref = next(r for r in rows if r is not None)
    return torch.stack([torch.zeros_like(ref) if r is None else r for r in rows], dim=2)


def kkt_block_product_batch(terms, nrows):
    """``kkt_block_product`` for a batch: each term is ``(phi_l, A, phi_r,
    x, row)`` with operands of shapes (B, l, s, r), (B, s, m, n, S),
    (B, L, S, R), (B, r, n, R); returns (B, l, nrows, m, L) from one
    launch.  Each instance sums its terms in the single entry's order."""
    stats = STATS["kkt_block_matvec"]
    terms = [tuple(t) for t in terms]
    tensors = [t for term in terms for t in term[:4]]
    B = _batch_len("kkt_block_product", tensors, [3, 4, 3, 3] * len(terms))
    dims = _k2_check([(*(t[0] for t in term[:4]), term[4]) for term in terms], nrows)
    if not _on_cuda(*tensors):
        stats.plain_calls += 1
        return kkt_block_product_batch_plain(terms, nrows)
    out = _k2_launch(terms, nrows, dims, B)
    stats.count(_tag(terms[0][3]), grouped=True, batch=B)
    return out


def panel_qr_batch_plain(a, transposed=False):
    q, r = torch.linalg.qr(a, mode="reduced")
    return (q.mT.contiguous() if transposed else q), r


def panel_qr_batch(a, transposed=False):
    """``panel_qr`` of a batch of panels ``a`` (B, m, n) (any strides):
    q (B, m, n), or (B, n, m) contiguous with ``transposed``, and r
    (B, n, n), from one launch (one CTA, or one cluster, an instance)."""
    stats = STATS["panel_qr"]
    _batch_len("panel_qr", [a], [2])
    if not _on_cuda(a):
        stats.plain_calls += 1
        return panel_qr_batch_plain(a, transposed)
    out = _k3_launch(a, transposed)
    stats.count(_tag(a), batch=a.shape[0])
    return out


def panel_cholesky_batch_plain(a):
    return torch.linalg.cholesky_ex(a)


def panel_cholesky_batch(a):
    """``panel_cholesky`` of a batch ``a`` (B, n, n) (any strides):
    ``(L, info)`` with L (B, n, n) and info (B,) as ``cholesky_ex`` gives
    them.  One launch up to order 512; above it the call launches the
    blocked factorization once per instance."""
    stats = STATS["panel_cholesky"]
    _batch_len("panel_cholesky", [a], [2])
    if a.shape[1] != a.shape[2]:
        raise KernelError(f"panel_cholesky: square matrices expected, got {tuple(a.shape)}")
    if not _on_cuda(a):
        stats.plain_calls += 1
        return panel_cholesky_batch_plain(a)
    out = _k4_launch(a)
    stats.count(_tag(a), batch=a.shape[0])
    return out


# ---------------------------------------------------------------------------
# J1 / J2: the Jacobi cores of the SVD and of eigh (float64, batched)
# ---------------------------------------------------------------------------

# Largest even order of each kernel (kMaxBlockN in csrc/jacobi_svd.cu,
# kMaxN in csrc/jacobi_eigh.cu): J1 to K3's column bound, which bounds the
# tall pipeline's QRs (its element regime holds W and V of an instance in
# one CTA's shared memory, to order 118); J2 spreads A over a cluster of
# CTAs (element regime: A twice and V over at most 8; block regime: a
# slot's block columns of A twice a CTA, V in device memory).
J1_MAX_N = 128
J1_ELEMENT_MAX_N = 118
# J1's regimes, by order (csrc/jacobi_svd.cu): the element kernel up to
# J1_BLOCK_FROM - 2, the two-level (block) one-sided Jacobi with blocks of
# J1_BLOCK columns from J1_BLOCK_FROM on (and above J1_ELEMENT_MAX_N
# whatever the crossover); a CTA a pair of blocks, J1_BLOCK^2 threads, at
# most 4 CTAs a cluster.  Both measured on the card on the r2^T operands of
# the maxcut d8, d10 and f32 d8 solves (PERF.md): blocks of 16 are
# the faster from order 22 at every order the solves give, and than blocks
# of 8 at 52-64 and 80-128 (8 won at some orders below; not kept).  The
# crossover is 34, not 22: the f32 d8 seed 319 solve (chip_smoke.py phase
# 9) turns on the SVDs' last bits and stops unconverged with the block
# regime from 22-24 (and from 56), converges in 8 iterations from 26-30
# and in 11 from 34-48 and 66; J1's outputs hold their invariants in
# every case.
J1_BLOCK = 16
J1_BLOCK_FROM = 34
_J1_BLOCK_MAX_CTAS = 4
J2_MAX_N = 272
_J2_CTAS = (1, 2, 4, 8)
# J2's regimes, by order (csrc/jacobi_eigh.cu): the element kernel up to
# J2_BLOCK_FROM - 2, the two-level (block) kernel with blocks of J2_BLOCK
# indices from J2_BLOCK_FROM on.  The crossover was measured on the card
# (PERF.md): the block kernel is the faster from order 24, but with it at
# 24-64 the maxcut d9 seed 9313 solve stops unconverged (its J2 outputs
# all hold their invariants; the solve turns on their last bits), and
# from 66 on every seed of tools/bench.py's default grid converges.  The
# block kernel's threads (kBlockThreads: one 2 x 2 block of the inner
# tile each) and its largest cluster (non-portable above 8 CTAs).
J2_BLOCK = 16
J2_BLOCK_FROM = 66
_J2_BLOCK_THREADS = 256
_J2_BLOCK_MAX_CTAS = 16


def _j1_smem(n):
    """csrc/jacobi_svd.cu::smem_bytes: W and V column-major with an odd
    leading dimension, the column norms, 64 words of reduction scratch."""
    return 8 * (2 * n * (n | 1) + n + 64)


def _j1_block_smem(n):
    """csrc/jacobi_svd.cu::block_smem_bytes: the slot's 2 block columns of W
    and of V twice (leading dimension n rounded up to 16, plus 4), the
    inner sweep's two tiles, U, the inner step's rotations (two parities),
    the cluster's maxima; the flags (two parities) and the votes."""
    m = 2 * J1_BLOCK
    return 8 * (4 * m * (-(-n // 16) * 16 + 4) + 2 * m * (m + 1) + m * (m + 4) + 4 * J1_BLOCK +
                _J1_BLOCK_MAX_CTAS) + 4 * (2 * _J1_BLOCK_MAX_CTAS + 2)


def _j2_smem(n, ctas):
    """csrc/jacobi_eigh.cu::smem_bytes: a CTA's ceil(n / ctas) columns of A
    twice (the step reads one copy and writes the other) and its rows of V,
    each with an odd leading dimension; the step's rotations,
    reduction scratch, each owned column's partner address; the step's
    pairs, each owned column's pair and the sweep's two flags."""
    nc = -(-n // ctas)
    h = n // 2
    return 8 * (3 * nc * (n | 1) + 2 * h + 48 + nc) + 4 * (2 * h + nc + 2)


def _j2_block_smem(n, ctas):
    """csrc/jacobi_eigh.cu::block_smem_bytes: the slot's 2 block columns of
    A twice (leading dimension n rounded up to 16, plus 4), each copy at
    least the inner sweep's two tiles (the copies trade places); every
    slot's U (leading dimension 2 block + 4); the inner step's rotations
    (two parities); the cluster's maxima and flags."""
    m = 2 * J2_BLOCK
    copy = max(m * (-(-n // 16) * 16 + 4), 2 * m * (m + 1))
    return 8 * (2 * copy + ctas * m * (m + 4) + 4 * J2_BLOCK + _J2_BLOCK_MAX_CTAS) + \
        4 * (_J2_BLOCK_MAX_CTAS + 2)


def _jacobi_order(name, x, limit):
    if x.dim() != 3 or x.shape[1] != x.shape[2] or x.shape[1] % 2 or x.shape[0] == 0:
        raise KernelError(f"{name}: a batch of square matrices of even order expected, got "
                          f"{tuple(x.shape)}")
    if x.dtype != torch.float64:
        raise KernelError(f"{name}: the Jacobi kernels take float64, got {x.dtype}")
    n = x.shape[1]
    if not 2 <= n <= limit:
        raise KernelError(f"{name}: orders 2 to {limit}, got {n}")
    return n


@functools.lru_cache(maxsize=512)
def j1_plan(n, element=False, block=False):
    """(block, ctas, threads, smem_bytes) of J1 at even order n <= J1_MAX_N
    in the regime of the order (J1_BLOCK_FROM), or in the element regime
    with ``element``, or in the block regime with ``block``
    (measurements).  Element regime (block 0, to J1_ELEMENT_MAX_N): one CTA
    an instance, a warp per pair of a step, at most 32.  Block regime
    (block J1_BLOCK): ceil(n / J1_BLOCK) blocks rounded up to even, a CTA a
    slot (a pair of blocks), J1_BLOCK^2 threads."""
    if n % 2 or not 2 <= n <= J1_MAX_N:
        raise KernelError(f"jacobi_orthogonalise: even orders 2 to {J1_MAX_N}, got {n}")
    if element and n > J1_ELEMENT_MAX_N:
        raise KernelError(f"jacobi_orthogonalise: the element regime takes orders to "
                          f"{J1_ELEMENT_MAX_N}, got {n}")
    if not block and (element or n < J1_BLOCK_FROM) and n <= J1_ELEMENT_MAX_N:
        return 0, 1, 32 * min(32, n // 2), _j1_smem(n)
    blocks = -(-n // J1_BLOCK)
    ctas = (blocks + blocks % 2) // 2
    smem = _j1_block_smem(n)
    if ctas > _J1_BLOCK_MAX_CTAS or smem > SMEM_LIMIT:
        raise KernelError(f"jacobi_orthogonalise: order {n} does not fit blocks of {J1_BLOCK}")
    return J1_BLOCK, ctas, J1_BLOCK * J1_BLOCK, smem


@functools.lru_cache(maxsize=1024)
def j2_plan(n, element=False):
    """(block, ctas, threads, smem_bytes) of J2 at even order n <= J2_MAX_N
    in the regime of the order (J2_BLOCK_FROM), or in the element regime
    with ``element`` (measurements).  Element regime (block 0): the fewest
    CTAs of a cluster (1, 2, 4, 8) whose shares fit in shared memory and a
    thread per (pair, column) of a CTA's update, at most 1024.  Block
    regime (block J2_BLOCK): ceil(n / J2_BLOCK) blocks rounded up to even,
    a CTA a slot (a pair of blocks), ``_J2_BLOCK_THREADS`` threads."""
    if n % 2 or not 2 <= n <= J2_MAX_N:
        raise KernelError(f"jacobi_eigh_core: even orders 2 to {J2_MAX_N}, got {n}")
    if element or n < J2_BLOCK_FROM:
        ctas = next(c for c in _J2_CTAS if _j2_smem(n, c) <= SMEM_LIMIT)
        work = (n // 2) * -(-n // ctas)
        return 0, ctas, min(1024, 32 * -(-work // 32)), _j2_smem(n, ctas)
    blocks = -(-n // J2_BLOCK)
    ctas = (blocks + blocks % 2) // 2
    smem = _j2_block_smem(n, ctas)
    if ctas > _J2_BLOCK_MAX_CTAS or smem > SMEM_LIMIT:
        raise KernelError(f"jacobi_eigh_core: order {n} does not fit blocks of {J2_BLOCK}")
    return J2_BLOCK, ctas, _J2_BLOCK_THREADS, smem


def jacobi_orthogonalise_plain(w, sweeps=False):
    """The plain version of the regime J1 takes at ``w``'s order: the
    element rule (``jacobi.orthogonalise_plain``) or the block algorithm
    (``jacobi.orthogonalise_block_plain``)."""
    from ttipm_tpu_torch.ops import jacobi

    if j1_plan(w.shape[-1])[0]:
        return jacobi.orthogonalise_block_plain(w, sweeps)
    return jacobi.orthogonalise_plain(w, sweeps)


def jacobi_eigh_core_plain(a, sweeps=False, vectors=True):
    """The plain version of the regime J2 takes at ``a``'s order: the
    element rule (``jacobi.eigh_core_plain``) or the block algorithm
    (``jacobi.eigh_block_plain``); v None without ``vectors``."""
    from ttipm_tpu_torch.ops import jacobi

    block = j2_plan(a.shape[-1])[0]
    out = jacobi.eigh_block_plain(a, sweeps) if block else jacobi.eigh_core_plain(a, sweeps)
    return out if vectors else (out[0], None, *out[2:])


def _j1_launch(w, count=None, plan=None, stamps=None):
    """J1 on ``w`` (B, n, n) f64 on the card: (w @ v, v, norms2); each
    instance's sweeps into ``count`` (B,) int32 when given.  ``plan``: a
    ``j1_plan`` other than the order's (measurements); ``stamps``: J1_STAMPS
    int64 zeros on the card that receive the clock stamps of a batch of
    one."""
    from ttipm_tpu_torch.ops import jacobi

    B, n, _ = w.shape
    block, ctas, threads, _ = plan or j1_plan(n)
    w = w.contiguous()
    out = torch.empty((2 * B * n * n + B * n,), dtype=w.dtype, device=w.device)
    w_rot, v = out[:B * n * n].view(B, n, n), out[B * n * n:2 * B * n * n].view(B, n, n)
    norms2 = out[2 * B * n * n:].view(B, n)
    stream, guard = _launch_env(w)
    with guard:
        if stamps is None:
            err = _lib().ttipm_jacobi_svd(_ptr(w), B, n, jacobi.tol_for(n), jacobi.SVD_FLOOR,
                                          _ptr(w_rot), _ptr(v), _ptr(norms2), _opt_ptr(count),
                                          block, ctas, threads, stream)
        elif B != 1:
            raise KernelError("jacobi_orthogonalise: clock stamps of a batch of one")
        else:
            err = _lib().ttipm_jacobi_svd_stamps(_ptr(w), n, jacobi.tol_for(n), jacobi.SVD_FLOOR,
                                                 _ptr(w_rot), _ptr(v), _ptr(norms2), block, ctas,
                                                 threads, _ptr(stamps), stream)
    _check("jacobi_orthogonalise", err)
    return w_rot, v, norms2


def _j2_launch(a, count=None, vectors=True, plan=None, stamps=None):
    """J2 on ``a`` (B, n, n) f64 on the card: (w ascending, v), v None
    without ``vectors`` (the kernel skips V); each instance's sweeps into
    ``count`` (B,) int32 when given.  ``plan``: a ``j2_plan`` other than
    the order's (measurements); ``stamps``: J2_STAMPS int64 zeros on the
    card that receive the clock stamps of a batch of one."""
    from ttipm_tpu_torch.ops import jacobi

    B, n, _ = a.shape
    block, ctas, threads, _ = plan or j2_plan(n)
    a = a.contiguous()
    nv = B * n * n if vectors else 0
    out = torch.empty((nv + B * n,), dtype=a.dtype, device=a.device)
    w = out[nv:].view(B, n)
    v = out[:nv].view(B, n, n) if vectors else None
    stream, guard = _launch_env(a)
    with guard:
        if stamps is None:
            err = _lib().ttipm_jacobi_eigh(_ptr(a), B, n, jacobi.tol_for(n), jacobi.EIGH_FLOOR,
                                           _ptr(w), _opt_ptr(v), _opt_ptr(count), block, ctas,
                                           threads, stream)
        elif B != 1:
            raise KernelError("jacobi_eigh_core: clock stamps of a batch of one")
        else:
            err = _lib().ttipm_jacobi_eigh_stamps(_ptr(a), n, jacobi.tol_for(n),
                                                  jacobi.EIGH_FLOOR, _ptr(w), _opt_ptr(v), block,
                                                  ctas, threads, _ptr(stamps), stream)
    _check("jacobi_eigh_core", err)
    if not vectors:
        return torch.sort(w, dim=-1, stable=True).values, None
    return jacobi.sort_eigenpairs(w, v)


# The clock stamps of ttipm_jacobi_eigh_stamps (csrc/jacobi_eigh.cu): the
# cycles of CTA 0's thread 0 summed by part over the factorization, then
# counts; the names by regime (0: element, 1: block).
J2_STAMPS = 16
J2_STAMP_PARTS = {
    0: ("setup", "remote_loads", "rotations", "rotations_wait", "update", "barrier", "store",
        "steps", "sweeps"),
    1: ("setup", "inner_rotations", "inner_update", "inner_barriers", "u_push", "column_dmma",
        "v_dmma", "barrier_1", "row_dmma_shift", "barrier_2", "store", "outer_steps",
        "inner_steps", "inner_steps_rotating", "sweeps", "quiet_inner_sweeps"),
}


# The clock stamps of ttipm_jacobi_svd_stamps (csrc/jacobi_svd.cu), as
# J2's; the names by regime (0: element, 1: block).
J1_STAMPS = 16
J1_STAMP_PARTS = {
    0: ("setup", "loads", "reductions", "rotation", "update", "barrier", "store", "steps",
        "sweeps"),
    1: ("setup", "gram", "inner_rotations", "inner_update", "inner_barriers", "products",
        "shift", "barrier", "store", "outer_steps", "inner_steps", "inner_steps_rotating",
        "sweeps", "quiet_inner_sweeps"),
}


def jacobi_svd_stamps(w, plan=None):
    """J1's clock stamps on one instance ``w`` (1, n, n) on the card, as
    {part: cycles} (``J1_STAMP_PARTS`` of the regime; the last entries are
    counts), from a launch that moves no counter."""
    plan = plan or j1_plan(w.shape[-1])
    stamps = torch.zeros(J1_STAMPS, dtype=torch.int64, device=w.device)
    _j1_launch(w, plan=plan, stamps=stamps)
    names = J1_STAMP_PARTS[int(plan[0] > 0)]
    return dict(zip(names, stamps[:len(names)].tolist()))


def jacobi_eigh_stamps(a, plan=None):
    """J2's clock stamps on one instance ``a`` (1, n, n) on the card, as
    {part: cycles} (``J2_STAMP_PARTS`` of the regime; the last entries are
    counts), from a launch that moves no counter."""
    plan = plan or j2_plan(a.shape[-1])
    stamps = torch.zeros(J2_STAMPS, dtype=torch.int64, device=a.device)
    _j2_launch(a, plan=plan, stamps=stamps)
    names = J2_STAMP_PARTS[int(plan[0] > 0)]
    return dict(zip(names, stamps[:len(names)].tolist()))


def jacobi_orthogonalise(w):
    """J1: one-sided Jacobi of each instance of ``w`` (B, n, n), n even, at
    most J1_MAX_N, float64: ``(w @ v, v, norms2)`` with v exactly
    orthonormal, the columns of w @ v orthogonal to the round-robin stop
    test and norms2 their squared norms; an instance that is not finite or
    does not converge in 26 sweeps comes out NaN.  One launch, a CTA or a
    cluster of CTAs an instance (``_jacobi_orthogonalise``,
    ttipm_tpu/ops/jacobi.py:121), in the regime of the order (``j1_plan``:
    element rotations below J1_BLOCK_FROM, the two-level block algorithm
    from there); ``STATS["jacobi_svd"].by_regime`` counts the launches of
    each."""
    stats = STATS["jacobi_svd"]
    _jacobi_order("jacobi_orthogonalise", w, J1_MAX_N)
    if not _on_cuda(w):
        stats.plain_calls += 1
        return jacobi_orthogonalise_plain(w)
    block = j1_plan(w.shape[1])[0]
    out = _j1_launch(w)
    stats.count("f64", batch=w.shape[0])
    stats.by_regime["block" if block else "element"] += 1
    return out


def jacobi_eigh_core(a, vectors=True):
    """J2: cyclic two-sided Jacobi of each symmetric instance of ``a``
    (B, n, n), n even, at most J2_MAX_N, float64: ``(w, v)``, eigenvalues
    ascending (ties in index order) and a = v diag(w) v^T; an instance
    that is not finite or does not converge in 26 sweeps comes out NaN.
    Without ``vectors`` ``(w, None)``: the kernel skips V, and w keeps its
    bits (A's rotations never read V).  One launch, a cluster of CTAs an
    instance (``_jacobi_eigh_core``, ttipm_tpu/ops/jacobi.py:370), in the
    regime of the order (``j2_plan``: element rotations below
    J2_BLOCK_FROM, the two-level block algorithm from there); the sort is a
    torch op on the kernel's diagonal."""
    stats = STATS["jacobi_eigh"]
    _jacobi_order("jacobi_eigh_core", a, J2_MAX_N)
    if not _on_cuda(a):
        stats.plain_calls += 1
        return jacobi_eigh_core_plain(a, vectors=vectors)
    block = j2_plan(a.shape[1])[0]
    out = _j2_launch(a, vectors=vectors)
    stats.count("f64", batch=a.shape[0])
    stats.by_regime["block" if block else "element"] += 1
    return out


def jacobi_sweeps(entry, x):
    """The sweeps each instance of ``x`` takes in ``entry``
    ("jacobi_orthogonalise" or "jacobi_eigh_core"; the block regimes
    count outer sweeps), as a (B,) int32 tensor, from a launch that moves
    no counter (or the plain version on CPU tensors)."""
    _jacobi_order(entry, x, J1_MAX_N if entry == "jacobi_orthogonalise" else J2_MAX_N)
    if not _on_cuda(x):
        plain = (jacobi_orthogonalise_plain if entry == "jacobi_orthogonalise"
                 else jacobi_eigh_core_plain)
        return plain(x, True)[-1]
    count = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    if entry == "jacobi_orthogonalise":
        _j1_launch(x, count)
    else:
        _j2_launch(x, count, vectors=False)
    return count
