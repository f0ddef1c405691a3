"""The port's CUDA kernels and its solve on the card (marked ``cuda``;
skipped without a GPU).

This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is compared with its plain PyTorch version by
``ttipm_tpu_torch.checks.check_kernel`` (tolerances stated there): at the
kernel phase's square shapes of chip_smoke.py, and at the odd shapes the
MaxCut solves give the kernels (rectangular interfaces, the 16-wide merged
eigen-window core, small and partial panels, Cholesky orders that are not
multiples of the 32-wide tile), and K4's own contract at and around its
regime boundaries (failing and NaN pivots, NaN above the diagonal,
non-contiguous operands, one kernel launch up to order 512), and K3's at
every regime of its envelope (one CTA, a cluster of row slabs), on rank-deficient, NaN and non-contiguous panels, with the
transposed output, one device kernel a call.  The grouped
entries of K1 and K2 run at the same regular and odd shapes with
non-contiguous operands, and every K1 / K2 call is one device kernel.  The
ragged local KKT solver runs on the card against its CPU run at m = 3600
with r != R, a failed K4 factorization sends it to LGMRES, the ragged
sweeps' block product is one K2 launch, the ragged eigensolver's LOBPCG
reaches the extremal pair above its dense gate, and the fully ragged IPM
(``set_fused_kkt(False)``) matches its CPU run.  The inequality path: K2
with the nine terms of its block products and K1 with groups of six blocks
of unequal operator ranks against their plain versions, the ragged
inequality local solver at its dense gate (r != R) and in its LGMRES
branch against its CPU run, and corr_clust d3 against its CPU run.  graphm:
the first Newton system of n=2 seed 256 (configs/graphm_2.yaml) solved by
the ragged AMEn with the inequality local solver on the card and on the
CPU, every kernel call of the card's solve held against its plain version.
The whole-solve path: its programs replayed from CUDA graphs bit-equal to
the same programs run eagerly on a d5 system and a d5 pencil, a host read
inside a step refused at capture, and the launch counts after three
replays.
"""

import functools
import os
from contextlib import contextmanager
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ttipm_tpu_torch.checks import check_kernel, tolerance
from ttipm_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


# Every kernel case runs on both instances: float64 and float32.
DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["f64", "f32"]
# The kernels with both instances (J1 and J2 take float64: f32 factorizations
# are upcast before them).
TYPED_KERNELS = ("schur_assemble", "kkt_block_matvec", "panel_qr", "panel_cholesky")


def _dev(rng, dev, *shape, dtype=torch.float64):
    return torch.as_tensor(rng.randn(*shape), device=dev).to(dtype)


def _device_kernel_names(fn):
    """Names of the device kernels of one call of ``fn`` (torch.profiler).
    A trace now and then comes back empty: the call is traced again, each
    time by a fresh profiler, up to five times a fifth of a second apart.
    Tests that call this run in a process of their own
    (``_in_own_process``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
        time.sleep(0.2)
    return names


_OWN_PROCESS = "TTIPM_TEST_OWN_PROCESS"


def _in_own_process(test):
    """Run the test (this parametrisation of it) again in a pytest process
    of its own, and pass or fail with it.  On the card, torch.profiler's
    traces came back without device events, many in a row, late in most
    whole runs of this file and never in its first tests, with the tests
    in either order and whether or not CUPTI was torn down between traces
    (the cause is not established); the device-kernel counts read those
    traces."""
    @functools.wraps(test)
    def run(*args, **kwargs):
        if os.environ.get(_OWN_PROCESS):
            return test(*args, **kwargs)
        node = os.environ["PYTEST_CURRENT_TEST"].rsplit(" ", 1)[0]
        done = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
             node], env=dict(os.environ, **{_OWN_PROCESS: "1"}), capture_output=True,
            text=True, timeout=600)
        assert done.returncode == 0, done.stdout[-4000:] + done.stderr[-2000:]
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 4, 9])
def test_cuda_contractions_match_plain(cuda, dtype, R, s):
    rng = np.random.RandomState(R + s)
    pl, A, pr = (_dev(rng, cuda, *sh, dtype=dtype) for sh in ((R, s, R), (s, 4, 4, s), (R, s, R)))
    x = _dev(rng, cuda, R, 4, R, dtype=dtype)
    K.reset_counts()
    y = K.kkt_block_matvec(pl, A, pr, x)
    B = K.schur_assemble(pl, A, pr)
    torch.cuda.synchronize()
    assert K.STATS["kkt_block_matvec"].launches == 1
    assert K.STATS["schur_assemble"].launches == 1
    check_kernel("kkt_block_matvec", (pl, A, pr, x), y)
    check_kernel("schur_assemble", (pl, A, pr), B)


# (phi_l, A, phi_r) shapes of the kind the MaxCut solves launch
ODD_CONTRACTIONS = [
    ((1, 1, 1), (1, 4, 4, 4), (2, 4, 2)),
    ((2, 4, 2), (4, 2, 2, 1), (1, 1, 1)),
    ((10, 1, 10), (1, 4, 4, 1), (1, 1, 1)),
    ((2, 1, 4), (1, 4, 4, 1), (4, 1, 4)),
    ((1, 1, 1), (1, 4, 4, 5), (10, 5, 10)),
    ((5, 3, 7), (3, 16, 16, 2), (6, 2, 4)),
    ((8, 5, 8), (5, 16, 16, 5), (8, 5, 8)),
]


@pytest.mark.cuda
def test_cuda_wrappers_launch_the_instance_of_the_operands_type(cuda):
    """Each wrapper launches the instance of its operands' type and counts
    it there; no wrapper changes an operand's type: f16 operands and
    operands of mixed types are refused before any launch, on the card as
    on the CPU."""
    rng = np.random.RandomState(4)
    for dtype, tag in zip(DTYPES, DTYPE_IDS):
        pl, A, pr = (_dev(rng, cuda, *sh, dtype=dtype) for sh in ((4, 2, 4), (2, 4, 4, 2),
                                                                 (4, 2, 4)))
        x = _dev(rng, cuda, 4, 4, 4, dtype=dtype)
        K.reset_counts()
        outs = [K.kkt_block_matvec(pl, A, pr, x), K.schur_assemble(pl, A, pr),
                *K.panel_qr(_dev(rng, cuda, 24, 6, dtype=dtype)),
                K.panel_cholesky(_spd(40, cuda, dtype=dtype))[0]]
        torch.cuda.synchronize()
        assert all(o.dtype == dtype for o in outs)
        for name in TYPED_KERNELS:  # the Jacobi cores take f64 only (their own test)
            st = K.STATS[name]
            assert st.by_dtype == {t: int(t == tag) for t in DTYPE_IDS}, (st.name, st.by_dtype)
    a64, a32 = _dev(rng, cuda, 4, 2, 4), _dev(rng, cuda, 4, 2, 4, dtype=torch.float32)
    A64, x64 = _dev(rng, cuda, 2, 4, 4, 2), _dev(rng, cuda, 4, 4, 4)
    half = _dev(rng, cuda, 24, 6).half()
    bad_calls = [
        lambda: K.kkt_block_matvec(a32, A64, a64, x64),                 # mixed types
        lambda: K.schur_assemble(a64, A64, a32),
        lambda: K.kkt_block_product([(a64, A64, a64, x64, 0), (a32, A64.float(), a32,
                                                              x64.float(), 0)], 1),
        lambda: K.schur_assemble_group([(a64, A64, a64), (a32, A64.float(), a32)]),
        lambda: K.panel_qr(half),                                        # f16
        lambda: K.panel_cholesky(half[:6]),
        lambda: K.kkt_block_matvec(a64.half(), A64.half(), a64.half(), x64.half()),
    ]
    K.reset_counts()
    for i, call in enumerate(bad_calls):
        with pytest.raises(K.KernelError):
            call()
            pytest.fail(f"call {i} was not refused")
    assert all((s.launches, s.plain_calls) == (0, 0) for s in K.STATS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shapes", ODD_CONTRACTIONS)
def test_cuda_contractions_odd_shapes(cuda, dtype, shapes):
    rng = np.random.RandomState(sum(map(sum, shapes)))
    pl, A, pr = (_dev(rng, cuda, *sh, dtype=dtype) for sh in shapes)
    x = _dev(rng, cuda, shapes[0][2], shapes[1][2], shapes[2][2], dtype=dtype)
    check_kernel("kkt_block_matvec", (pl, A, pr, x), K.kkt_block_matvec(pl, A, pr, x))
    check_kernel("schur_assemble", (pl, A, pr), K.schur_assemble(pl, A, pr))


def _group_operands(rng, dev, left, right, ranks, m=4, dtype=torch.float64):
    """A block product's six terms and a group of four Schur blocks on
    interfaces (l, s, r) / (L, S, R) with the outer dims ``left = (l, r)``,
    ``right = (L, R)`` and per-block operator ranks ``ranks``; the third
    term and second block are flipped / transposed views."""
    (l, r), (L, R) = left, right

    def t(*shape):
        return _dev(rng, dev, *shape, dtype=dtype)

    x = t(r, 3, m, R)
    ops = [(t(l, s, r), t(s, m, m, S), t(L, S, R)) for s, S in ranks]
    s, S = ranks[0]
    flipped = (t(r, s, l).permute(2, 1, 0), t(s, m, m, S).transpose(1, 2),
               t(R, S, L).permute(2, 1, 0))
    assert not any(t.is_contiguous() for t in flipped) or min(l, r, L, R, s, S) == 1
    terms = [(*ops[0], x[:, 0], 0), (*ops[1], x[:, 1], 0), (*flipped, x[:, 0], 1),
             (*ops[2], x[:, 2], 1), (*ops[3], x[:, 1], 2), (*ops[4], x[:, 2], 2)]
    return terms, [ops[3], flipped, ops[4], ops[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 4, 9])
def test_cuda_grouped_contractions_match_plain(cuda, dtype, R, s):
    rng = np.random.RandomState(100 + R + s)
    ranks = [(s, s), (s + 1, s), (1, 1), (s, s + 2), (2, s)]
    terms, blocks = _group_operands(rng, cuda, (R, R), (R, R), ranks, dtype=dtype)
    K.reset_counts()
    y = K.kkt_block_product(terms, 3)
    B = K.schur_assemble_group(blocks)
    torch.cuda.synchronize()
    for name in ("kkt_block_matvec", "schur_assemble"):
        st = K.STATS[name]
        assert (st.launches, st.grouped, st.plain_calls) == (1, 1, 0)
    assert tuple(y.shape) == (R, 3, 4, R) and len(B) == 4
    check_kernel("kkt_block_product", (terms, 3), y)
    check_kernel("schur_assemble_group", (blocks,), B)
    # rows without a term are zero
    y4 = K.kkt_block_product(terms, 4)
    assert float(y4[:, 3].abs().max()) == 0.0 and torch.equal(y4[:, :3], y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("kkt", [2, 3])
def test_cuda_partial_s_schur_assemble(cuda, dtype, kkt):
    """K1 over a slice of the operator bond s, the kkt mesh's partial
    blocks (``Mesh.partial_schur``): strided views ``phi_l[:, :, lo:hi]``,
    ``A[:, lo:hi]`` of a batch of the d10 local factor's blocks (R = 16,
    operator ranks 4, 1, 5 and 9, B = 3).  Each partial against its plain
    version, and the sum of the partials against the full K1, to K1's
    tolerance."""
    from ttipm_tpu_torch.checks import check_batch

    rng = np.random.RandomState(40 + kkt)
    B, R = 3, 16
    blocks = [(_dev(rng, cuda, B, R, s, R, dtype=dtype), _dev(rng, cuda, B, s, 4, 4, S,
                                                             dtype=dtype),
               _dev(rng, cuda, B, R, S, R, dtype=dtype))
              for s, S in ((4, 4), (1, 3), (5, 2), (9, 9))]
    full = K.schur_assemble_batch(blocks)
    total = torch.zeros_like(full)
    for k in range(kkt):
        part = []
        for pl, a, pr in blocks:
            lo, hi = k * a.shape[1] // kkt, (k + 1) * a.shape[1] // kkt
            part.append((pl[:, :, lo:hi], a[:, lo:hi], pr) if hi > lo else None)
        live = [p for p in part if p is not None]
        assert any(not p[0].is_contiguous() for p in live)
        got = K.schur_assemble_batch(live)
        check_batch("schur_assemble_batch", (live,), got)
        it = iter(got)
        total += torch.stack([next(it) if p is not None else torch.zeros_like(full[0])
                              for p in part])
    check_batch("schur_assemble_batch", (blocks,), full)
    ref = K.schur_assemble_batch_plain(blocks)
    assert float(torch.linalg.norm(total - full)) <= tolerance("schur_assemble", dtype) * float(
        torch.linalg.norm(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shapes", ODD_CONTRACTIONS)
def test_cuda_grouped_contractions_odd_shapes(cuda, dtype, shapes):
    (l, s, r), (_, m, _, S), (L, _, R) = shapes
    rng = np.random.RandomState(7 + sum(map(sum, shapes)))
    ranks = [(s, S), (S, s), (1, 2), (s + 3, 1), (2, S + 1)]
    terms, blocks = _group_operands(rng, cuda, (l, r), (L, R), ranks, m=m, dtype=dtype)
    check_kernel("kkt_block_product", (terms, 3), K.kkt_block_product(terms, 3))
    check_kernel("schur_assemble_group", (blocks,), K.schur_assemble_group(blocks))
    check_kernel("schur_assemble_group", (blocks[:2],), K.schur_assemble_group(blocks[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("dims", [(36, 100, 36, 4, 4, 100, 36, 36), (3, 40, 5, 16, 16, 30, 4, 6),
                                  (70, 2, 3, 4, 4, 2, 3, 3)])
def test_cuda_kkt_block_matvec_tiled_and_chunked(cuda, dtype, dims):
    """Operator ranks that force tiles of R, a wide physical index, and
    more values of l than the grid has chunks."""
    l, s, r, m, n, S, L, R = dims
    rng = np.random.RandomState(sum(dims))
    args = tuple(_dev(rng, cuda, *sh, dtype=dtype)
                 for sh in ((l, s, r), (s, m, n, S), (L, S, R), (r, n, R)))
    check_kernel("kkt_block_matvec", args, K.kkt_block_matvec(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_cuda_schur_assemble_rebuilds_w_for_huge_operator_rank(cuda, dtype):
    """S beyond the resident chunk of W: the slice is rebuilt per column tile
    (the f32 instance holds twice the elements, so its S is twice as long)."""
    rng = np.random.RandomState(5)
    esize = K.ELEMENT_BYTES[K.DTYPES[dtype]]
    S = 2000 * 8 // esize
    args = tuple(_dev(rng, cuda, *sh, dtype=dtype) for sh in ((3, 2, 5), (2, 4, 4, S),
                                                              (9, S, 9)))
    assert K.k1_tiles((K._dims("schur_assemble", args),), esize)[1] < S
    check_kernel("schur_assemble", args, K.schur_assemble(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R,s", [(8, 4), (32, 9)])
@_in_own_process
def test_cuda_contractions_are_one_device_kernel(cuda, dtype, R, s):
    """Exactly one device kernel per K1 / K2 call, single or grouped, on
    contiguous and on flipped operands: no GEMM, copy or elementwise
    kernel from inside the wrappers; and one wrapper call per block
    product of the fused algebra (a batch of one, as the single solve runs
    it)."""
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1

    rng = np.random.RandomState(R)
    ranks = [(s, s), (s + 1, s), (1, 1), (s, s + 2), (2, s)]
    terms, blocks = _group_operands(rng, cuda, (R, R), (R, R), ranks, dtype=dtype)
    keys = ("00", "01", "12", "21", "22")
    pl = {k: _dev(rng, cuda, R, s, R, dtype=dtype) for k in keys + ("10",)}
    pr = {k: _dev(rng, cuda, R, s, R, dtype=dtype) for k in keys + ("10",)}
    A = {k: _dev(rng, cuda, s, 4, 4, s, dtype=dtype) for k in keys}
    x = _dev(rng, cuda, R, 3, 4, R, dtype=dtype)
    pl, pr, A, x = b1((pl, pr, A, x))
    calls = {
        "kkt_block_product": lambda: K.kkt_block_product(terms, 3),
        "kkt_block_matvec": lambda: K.kkt_block_matvec(*terms[2][:4]),
        "schur_assemble_group": lambda: K.schur_assemble_group(blocks),
        "schur_assemble": lambda: K.schur_assemble(*blocks[1]),
        "apply_T": lambda: fb.apply_T(pl["01"], A["01"], pr["01"], x[:, :, 0]),
        "local_product": lambda: fb.local_product(pl, A, pr, x),
        "z_product": lambda: fb.z_product(pl, A, pr, x),
        "mixed_product": lambda: fb.mixed_product(pl, pr, A, x, True),
        "mixed_product_left": lambda: fb.mixed_product(pl, pr, A, x, False),
    }
    _device_kernel_names(calls["schur_assemble"])
    for name, call in calls.items():
        kernels = _device_kernel_names(call)
        assert len(kernels) == 1, (name, kernels)
        assert not any(w in kernels[0].lower() for w in ("gemm", "copy", "elementwise")), kernels
        K.reset_counts()
        call()
        assert sum(st.launches for st in K.STATS.values()) == 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R", [8, 16, 32])
def test_cuda_panel_qr_contract(cuda, dtype, R):
    a = _dev(np.random.RandomState(R), cuda, 4 * R, R + 2, dtype=dtype)
    K.reset_counts()
    q, r = K.panel_qr(a)
    torch.cuda.synchronize()
    assert K.STATS["panel_qr"].launches == 1
    check_kernel("panel_qr", (a,), (q, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", [(24, 6), (16, 6), (40, 10), (16, 10), (5, 5), (33, 1),
                                (100, 34)])
def test_cuda_panel_qr_odd_shapes(cuda, dtype, mn):
    a = _dev(np.random.RandomState(sum(mn)), cuda, *mn, dtype=dtype)
    check_kernel("panel_qr", (a,), K.panel_qr(a))
    if mn[1] > 2:  # rank-deficient: a repeated and a zero column
        a[:, 1] = a[:, 0]
        a[:, 2] = 0.0
        check_kernel("panel_qr", (a,), K.panel_qr(a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("scale", [1e-25, 1e-15, 1e15, 1e20])
@pytest.mark.parametrize("mn", [(40, 10), (300, 20)])
def test_cuda_panel_qr_column_scales(cuda, dtype, scale, mn):
    """K3 takes a scaled norm where the plain sum of squares underflows or
    overflows (csrc/panel_qr.cu): with its first column scaled by 1e-25,
    1e-15, 1e15 or 1e20 a panel keeps the contract column by column in both
    types, in one CTA and in a cluster: Q R = a and Q^T Q = I."""
    a = _dev(np.random.RandomState(sum(mn)), cuda, *mn, dtype=dtype)
    a[:, 0] *= scale
    q, r = K.panel_qr(a)
    torch.cuda.synchronize()
    ad, qd, rd = a.double(), q.double(), r.double()
    tol = tolerance("panel_qr", dtype)
    assert float(((qd @ rd - ad).norm(dim=0) / ad.norm(dim=0)).max()) <= tol
    assert float((qd.T @ qd - torch.eye(mn[1], device=cuda, dtype=qd.dtype)).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", [(40, 10), (300, 20)])
def test_cuda_panel_qr_zero_below_diagonal(cuda, dtype, mn):
    """A first column that is exactly zero below the diagonal takes no
    reflector (tau = 0, as LAPACK decides): R's first row is a's, Q's first
    column is e_0, and the contract holds."""
    a = _dev(np.random.RandomState(sum(mn)), cuda, *mn, dtype=dtype)
    a[1:, 0] = 0.0
    q, r = K.panel_qr(a)
    torch.cuda.synchronize()
    assert torch.equal(r[0], a[0])
    assert torch.equal(q[:, 0], torch.eye(mn[0], 1, device=cuda, dtype=dtype)[:, 0])
    ad, qd, rd = a.double(), q.double(), r.double()
    tol = tolerance("panel_qr", dtype)
    assert float(((qd @ rd - ad).norm(dim=0) / ad.norm(dim=0)).max()) <= tol
    assert float((qd.T @ qd - torch.eye(mn[1], device=cuda, dtype=qd.dtype)).abs().max()) <= tol


# K3's panels: the smoke test's list; the boundaries of its regimes (1, 2,
# 4 or 6 rows a lane; one CTA up to 192 rows, a cluster of 2 up to 384, of 4
# above); square panels, single columns, row counts that are no multiple
# of 32 or of the cluster.
K3_PANELS = [(24, 6), (40, 10), (32, 10), (64, 18), (128, 34), (144, 36), (512, 32), (512, 128),
             (32, 8), (33, 8), (64, 8), (65, 8), (128, 8), (129, 8), (192, 20), (193, 20),
             (384, 57), (385, 57), (300, 128), (511, 127), (257, 3),
             (5, 5), (36, 36), (128, 128), (1, 1), (33, 1), (512, 1), (100, 34), (257, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", K3_PANELS)
def test_cuda_panel_qr_envelope(cuda, dtype, mn):
    """The contract at every regime, with LAPACK's signs on the full-rank
    panel, then with a repeated and a zero column, then all zeros."""
    m, n = mn
    a = _dev(np.random.RandomState(m + n), cuda, m, n, dtype=dtype)
    K.reset_counts()
    q, r = K.panel_qr(a)
    torch.cuda.synchronize()
    assert (K.STATS["panel_qr"].launches, K.STATS["panel_qr"].plain_calls) == (1, 0)
    check_kernel("panel_qr", (a,), (q, r))
    r0 = torch.linalg.qr(a, mode="reduced")[1]
    assert torch.equal(torch.sign(torch.diagonal(r)), torch.sign(torch.diagonal(r0)))
    if n > 2:
        a[:, 1] = a[:, 0]
        a[:, 2] = 0.0
        check_kernel("panel_qr", (a,), K.panel_qr(a))
    z = torch.zeros_like(a)
    q, r = K.panel_qr(z)
    check_kernel("panel_qr", (z,), (q, r))
    assert float(r.abs().max()) == 0.0  # tau = 0 throughout: Q = I[:, :n]
    assert torch.equal(q, torch.eye(m, n, dtype=q.dtype, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", [(40, 10), (128, 34), (144, 36), (300, 20), (512, 128)])
def test_cuda_panel_qr_layouts(cuda, dtype, mn):
    """Transposed and strided operands are read in place; the transposed
    output is the contiguous (n, m) array q^T with the same bits as q."""
    m, n = mn
    rng = np.random.RandomState(m)
    a = _dev(rng, cuda, m, n, dtype=dtype)
    q, r = K.panel_qr(a)
    qt, rt = K.panel_qr(a, transposed=True)
    assert tuple(qt.shape) == (n, m) and qt.is_contiguous()
    assert torch.equal(qt, q.T) and torch.equal(rt, r)
    for view in (_dev(rng, cuda, n, m, dtype=dtype).T,
                 _dev(rng, cuda, 2 * m, 2 * n, dtype=dtype)[::2, ::2]):
        assert not view.is_contiguous()
        got = K.panel_qr(view)
        check_kernel("panel_qr", (view,), got)
        same = K.panel_qr(view.contiguous())
        assert torch.equal(got[0], same[0]) and torch.equal(got[1], same[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", [(40, 10), (300, 20), (512, 100)])
def test_cuda_panel_qr_nan_comes_out_as_nan(cuda, dtype, mn):
    a = _dev(np.random.RandomState(3), cuda, *mn, dtype=dtype)
    a[3, 4] = float("nan")
    q, r = K.panel_qr(a)
    torch.cuda.synchronize()  # no hang: no loop of the kernel depends on the data
    assert bool(torch.isnan(q).any()) and bool(torch.isnan(r).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", [(513, 10), (512, 129), (3, 5)])
def test_cuda_panel_qr_refuses_outside_the_envelope(cuda, dtype, mn):
    K.reset_counts()
    with pytest.raises(K.KernelError):
        K.panel_qr(torch.zeros(mn, dtype=dtype, device=cuda))
    assert (K.STATS["panel_qr"].launches, K.STATS["panel_qr"].plain_calls) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", [(24, 6), (40, 10), (128, 34), (144, 36), (512, 32), (512, 128)])
@_in_own_process
def test_cuda_panel_qr_is_one_device_kernel(cuda, dtype, mn):
    """One device kernel a call, in every regime and for either output
    layout and a transposed operand: no copy or elementwise kernel from
    inside the wrapper."""
    a = _dev(np.random.RandomState(1), cuda, *mn, dtype=dtype)
    at = _dev(np.random.RandomState(2), cuda, mn[1], mn[0], dtype=dtype).T
    for call in (lambda: K.panel_qr(a), lambda: K.panel_qr(a, transposed=True),
                 lambda: K.panel_qr(at)):
        names = _device_kernel_names(call)
        assert len(names) == 1 and "panel_qr" in names[0], names
        assert not any(w in names[0].lower() for w in ("gemm", "copy", "elementwise")), names


@pytest.mark.cuda
@_in_own_process
def test_cuda_backward_split_takes_q_transposed_without_a_copy(cuda):
    """The K3 site of bck_split_step is one device kernel: the core is a
    view of the kernel's q^T.  Against a K3 that hands back q for the caller
    to transpose, the step runs fewer device kernels and gives the same
    core."""
    from ttipm_tpu_torch.ops import jacobi
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1

    rng = np.random.RandomState(9)
    u_aug = _dev(rng, cuda, 32, 10)

    def site():
        qt, _ = K.panel_qr(u_aug, transposed=True)
        return qt.reshape(10, 4, 8)

    _device_kernel_names(site)
    names = _device_kernel_names(site)
    assert len(names) == 1 and "panel_qr" in names[0], names
    assert site().is_contiguous()

    rl, rr, rz, n, bs, sb = 8, 8, 2, 4, 3, 2
    keys = ("00", "01", "12", "21", "22")
    pl = {k: _dev(rng, cuda, rl, 2, rl) for k in keys}
    pr = {k: _dev(rng, cuda, rr, 2, rr) for k in keys}
    zl = {k: _dev(rng, cuda, rz, 2, rl) for k in keys + ("10",)}
    zr = {k: _dev(rng, cuda, rz, 2, rr) for k in keys + ("10",)}
    A = {k: _dev(rng, cuda, 2, 4, 4, 2) for k in keys}
    b = [_dev(rng, cuda, sb, n, sb) for _ in range(3)]
    bl, br = ([_dev(rng, cuda, sb, r) for _ in range(3)] for r in (rl, rr))
    zbl, zbr = ([_dev(rng, cuda, sb, rz) for _ in range(3)] for _ in range(2))
    x_k, z_k = _dev(rng, cuda, rl, bs, n, rr), _dev(rng, cuda, rz, bs, n, rz)
    x_nb, z_nb = _dev(rng, cuda, 2, n, rl), _dev(rng, cuda, 2, n, rz)

    ops = b1((pl, A, pr, bl, b, br, zl, zr, zbl, zbr, x_k, x_nb, z_k, z_nb))

    def solve_local(pl, A, pr, bl, b, br, x):  # a batch of one
        z = x.new_zeros(x.shape[0])
        return 0.5 * x + 0.1 * torch.roll(x, 1, dims=3), z, z, z

    def step():
        # the split's SVD through cuSOLVER: the Jacobi SVD launches K3 too,
        # and the K3 launches counted here are the site's alone
        with jacobi.forced(False):
            return fb.bck_split_step(solve_local, *ops, 8, 2, True)

    new_names = _device_kernel_names(step)
    core = step()[0]
    assert sum("panel_qr" in name for name in new_names) == 1
    original = K.panel_qr

    def untransposed(a, transposed=False):
        q, r = original(a)
        return (q.T if transposed else q), r

    K.panel_qr = untransposed
    try:
        old_names = _device_kernel_names(step)
        old_core = step()[0]
    finally:
        K.panel_qr = original
    assert len(new_names) < len(old_names), (len(new_names), len(old_names))
    assert torch.equal(core, old_core)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R", [8, 16, 32])
def test_cuda_panel_cholesky_contract(cuda, dtype, R):
    n = 4 * R * R
    B = _dev(np.random.RandomState(R), cuda, n, n, dtype=dtype)
    A = B @ B.T + n * torch.eye(n, dtype=B.dtype, device=cuda)
    check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    A[n // 3, n // 3] = -1.0
    errs = check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    assert errs["info"] == n // 3 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", [1, 4, 5, 16, 24, 33, 40, 96, 100, 144, 400])
def test_cuda_panel_cholesky_odd_orders(cuda, dtype, n):
    B = _dev(np.random.RandomState(n), cuda, n, n, dtype=dtype)
    A = B @ B.T + n * torch.eye(n, dtype=B.dtype, device=cuda)
    check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    A[n - 1, n - 1] = -1.0
    errs = check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    assert errs["info"] == n


def _spd(n, dev, seed=None, dtype=torch.float64):
    B = _dev(np.random.RandomState(n if seed is None else seed), dev, n, n, dtype=dtype)
    return B @ B.T + n * torch.eye(n, dtype=B.dtype, device=dev)


# K4's regime and tile boundaries: one CTA up to 160, a cluster up to 512
# (the resident bound), 64-wide panels above; 32-wide tiles inside.
K4_BOUNDARY_ORDERS = [1, 31, 32, 33, 63, 64, 65, 159, 160, 161, 511, 512, 513,
                      575, 576, 577, 5184]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", K4_BOUNDARY_ORDERS)
def test_cuda_panel_cholesky_regime_boundaries(cuda, dtype, n):
    A = _spd(n, cuda, dtype=dtype)
    L, info = K.panel_cholesky(A)
    torch.cuda.synchronize()
    check_kernel("panel_cholesky", (A,), (L, info))
    assert float(torch.triu(L, 1).abs().max()) == 0.0


# (order, 0-based failing pivot): first and last panel of each regime
K4_FAILING_PIVOTS = [(144, 3), (144, 140), (400, 5), (400, 399), (1000, 10), (1000, 999)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n,p", K4_FAILING_PIVOTS)
def test_cuda_panel_cholesky_failing_pivot(cuda, dtype, n, p):
    """info is the 1-based order of the first failing pivot (K4's contract;
    cholesky_ex on the card misses some negative last pivots, so the
    order is asserted, not compared with it)."""
    A = _spd(n, cuda, dtype=dtype)
    A[p, p] = -1.0
    _, info = K.panel_cholesky(A)
    assert int(info) == p + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n,p", [(144, 70), (400, 200), (1000, 500)])
def test_cuda_panel_cholesky_nan_pivot(cuda, dtype, n, p):
    A = _spd(n, cuda, dtype=dtype)
    A[p, p] = float("nan")
    _, info = K.panel_cholesky(A)
    assert int(info) == p + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", [100, 400, 1000])
def test_cuda_panel_cholesky_reads_only_the_lower_triangle(cuda, dtype, n):
    A = _spd(n, cuda, dtype=dtype)
    iu = torch.triu_indices(n, n, 1, device=cuda)
    A[iu[0], iu[1]] = float("nan")
    L, info = K.panel_cholesky(A)
    check_kernel("panel_cholesky", (A,), (L, info))
    assert bool(torch.isfinite(L).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", [96, 400, 700])
def test_cuda_panel_cholesky_non_contiguous(cuda, dtype, n):
    big = _spd(2 * n, cuda, dtype=dtype)
    for A in (big[::2, ::2], big[:n, :n].T):  # strided and transposed views
        assert not A.is_contiguous()
        check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", [16, 144, 256, 400, 512, 4096])
@_in_own_process
def test_cuda_panel_cholesky_launch_count(cuda, dtype, n):
    """One device kernel for every order up to 512; above it at most
    2 ceil(n / 64) + 2 (it takes two: a copy and one persistent kernel)."""
    A = _spd(n, cuda, dtype=dtype)
    kernels = _device_kernel_names(lambda: K.panel_cholesky(A))
    if n <= K.K4_RESIDENT_MAX_N:
        assert len(kernels) == 1, kernels
    else:
        assert 0 < len(kernels) <= 2 * -(-n // K.K4_PANEL) + 2


@pytest.mark.cuda
def test_cuda_solve_matches_cpu(cuda):
    """maxcut d2 on the card through the kernels: the CPU run's iterations
    and objective, and no plain version run on a CUDA tensor."""
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import tt as T

    out = {}
    for dev in ("cpu", "cuda"):
        rng = np.random.RandomState(11)
        obj, L, b, lag = create_problem(2, 1, device=dev, rng=rng)
        K.reset_counts()
        X, Y, _, Z, info = tt_ipm({"y": T.tt_reshape(lag, (4, 4))}, obj, L, b,
                                  max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3,
                                  mals_restarts=2, rng=rng)
        out[dev] = (info["num_iters"], T.tt_inner_prod(T.tt_reshape(obj, (2, 2)), X))
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-6)
    assert all(s.plain_calls == 0 for s in K.STATS.values())
    assert K.STATS["kkt_block_matvec"].launches > 0


def _local_system(dev, r, R, spd=True, seed=0, ineq=False):
    """A projected equality KKT system at one core of the ragged sweeps
    (bond ranks r on the left, R on the right; m = 4 r R), as
    ``ipm_local_solver`` takes it: the L_Z block is SPD (Kronecker product
    of SPD factors) unless ``spd`` is false.  With ``ineq`` the inequality
    system of ``ipm_local_solver_ineq``: the (3,1) and (3,3) blocks, the
    (1,2) -> (1,3) alias and a fourth row."""
    from ttipm_tpu_torch.solvers.blocks import TTBlockMatrix, TTBlockVector

    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape), device=dev)

    def spd_mat(n, shift=1.0):
        a = rng.randn(n, n)
        return a @ a.T / n + shift * np.eye(n)

    def phi(n, s):
        return torch.as_tensor(np.stack([spd_mat(n)] * s, axis=1), device=dev)

    lz = spd_mat(4)
    if not spd:
        lz -= 3.0 * np.eye(4)
    mat = TTBlockMatrix()
    mat[0, 0] = [t(1, 4, 4, 2)]
    mat[0, 1] = [t(1, 4, 4, 2)]
    mat[1, 2] = [torch.eye(4, dtype=torch.float64, device=dev).reshape(1, 4, 4, 1)]
    mat[2, 1] = [torch.as_tensor(lz, device=dev).reshape(1, 4, 4, 1)]
    mat[2, 2] = [torch.as_tensor(spd_mat(4), device=dev).reshape(1, 4, 4, 1)]
    mat.add_alias((0, 1), (1, 0), is_transpose=True)
    rows = 4 if ineq else 3
    vec = TTBlockVector()
    for i in range(rows):
        vec[i] = [t(2, 4, 3)]
    def eye(n):
        return torch.eye(n, dtype=torch.float64, device=dev).reshape(n, 1, n)

    XL = {(0, 0): t(r, 1, r), (0, 1): t(r, 1, r), (1, 2): eye(r), (2, 1): phi(r, 1),
          (2, 2): phi(r, 1)}
    XR = {(0, 0): t(R, 2, R), (0, 1): t(R, 2, R), (1, 2): eye(R), (2, 1): phi(R, 1),
          (2, 2): phi(R, 1)}
    if ineq:
        mat[3, 1] = [torch.as_tensor(np.diag(rng.rand(4)), device=dev).reshape(1, 4, 4, 1)]
        mat[3, 3] = [torch.as_tensor(spd_mat(4), device=dev).reshape(1, 4, 4, 1)]
        mat.add_alias((1, 2), (1, 3))
        XL.update({(3, 1): phi(r, 1), (3, 3): phi(r, 1)})
        XR.update({(3, 1): phi(R, 1), (3, 3): phi(R, 1)})
    bl = {i: t(2, r) for i in range(rows)}
    br = {i: t(3, R) for i in range(rows)}
    return XL, mat[0], XR, bl, vec[0], br, t(r, rows, 4, R)


@pytest.mark.cuda
def test_cuda_f32_solve_matches_cpu(cuda):
    """maxcut d3 seed 319 in the f32 profile (native eigen pencils, f64
    local solves) on the card and on the CPU: both converge, iterations
    within one, <C, X> to 1e-3 relative (f32 sums in other orders move the
    trajectory's last bits); on the card every f32 instance launches and no
    plain version runs."""
    from ttipm_tpu_torch import config as tconfig
    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import tt as T

    out = {}
    tconfig.set_dtype(torch.float32)
    tconfig.set_eigen_dtype("native")
    try:
        for dev in ("cpu", "cuda"):
            rng = np.random.RandomState(319)
            obj, L, b, lag = create_problem(3, 1, device=dev, dtype=torch.float32, rng=rng)
            K.reset_counts()
            X, Y, _, Z, info = tt_ipm({"y": T.tt_reshape(lag, (4, 4))}, obj, L, b,
                                      max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3,
                                      warm_up=3, aho_direction=False, mals_restarts=2,
                                      max_refinement=5, lambdaStar=1.0, rng=rng)
            assert X[0].dtype == torch.float32
            assert max(solve_metrics(X, Y, Z, obj, L, b)) < 1e-3, dev
            out[dev] = (info["num_iters"], T.tt_inner_prod(T.tt_reshape(obj, (2, 2)), X))
    finally:
        tconfig.set_dtype(torch.float64)
        tconfig.set_eigen_dtype("f64")
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-3)
    assert all(s.plain_calls == 0 for s in K.STATS.values())
    assert all(K.STATS[n].by_dtype["f32"] > 0 for n in TYPED_KERNELS), \
        {n: s.by_dtype for n, s in K.STATS.items()}
    # the f32 profile's factorizations run in f64 on upcast operands
    assert K.STATS["jacobi_svd"].by_dtype["f64"] > 0 and K.STATS["jacobi_eigh"].by_dtype["f64"] > 0


@pytest.mark.cuda
def test_cuda_f32_split_svd_keeps_u_orthonormal_at_zero_singular_values(cuda):
    """tests/test_jacobi.py:114-139's rank-deficient gallery on the card's
    f32 SVD (cuSOLVER) and on the port's split SVD (an f64 SVD rounded to
    f32): u orthonormal to 1e-5, vt bounded, the split exact to 1e-4; and a
    tall panel with a repeated and a zero column."""
    from ttipm_tpu_torch.ops.linalg import fast_split_svd

    rng = np.random.RandomState(5)
    base = rng.randn(4, 24).astype(np.float32)
    u0, s0, vt0 = np.linalg.svd(base, full_matrices=False)
    s0[3] = 0.0
    deficient = rng.randn(32, 10).astype(np.float32)
    deficient[:, 3] = deficient[:, 1]
    deficient[:, 5] = 0.0
    for a in (u0 @ np.diag(s0) @ vt0, (u0 @ np.diag(s0) @ vt0).T, deficient, deficient.T):
        at = torch.as_tensor(np.ascontiguousarray(a), device=cuda)
        for fn in (fast_split_svd, lambda t: torch.linalg.svd(t, full_matrices=False)):
            _check_split(a, *(t.double().cpu().numpy() for t in fn(at)))


def _check_split(a, u, s, vt):
    assert np.abs(u).max() < 1.5
    assert np.abs(u.T @ u - np.eye(u.shape[1])).max() < 1e-5
    assert np.abs(vt).max() < 1e3
    assert np.abs(u @ (s[:, None] * vt) - a).max() < 1e-4 * max(1.0, np.abs(a).max())


@pytest.mark.cuda
def test_cuda_ragged_local_solver_matches_cpu(cuda):
    """The ragged local KKT solve at m = 4 r R = 3600 with r != R (the d10
    dense gate's largest order) on the card (K1 group, K4 blocked regime,
    K2 applies) against the CPU run of the plain versions."""
    from ttipm_tpu_torch.solvers.local_kkt import ipm_local_solver

    out = {}
    for dev in ("cpu", cuda):
        K.reset_counts()
        out[str(dev)] = ipm_local_solver(*_local_system(dev, 25, 36), 30)
        if dev != "cpu":
            assert K.STATS["schur_assemble"].launches == 1
            assert K.STATS["panel_cholesky"].launches == 1
            assert all(s.plain_calls == 0 for s in K.STATS.values())
    sol_c, old_c, new_c, rhs_c, nrm_c, fail_c = out["cpu"]
    sol_g, old_g, new_g, rhs_g, nrm_g, fail_g = out[str(cuda)]
    assert not fail_c and not fail_g
    # the two sum in different orders; the Schur system's conditioning
    # carries that to the solution
    assert float(torch.linalg.norm(sol_g.cpu() - sol_c)) <= 1e-9 * float(torch.linalg.norm(sol_c))
    assert new_g < 1e-9 and new_c < 1e-9


@pytest.mark.cuda
def test_cuda_failed_cholesky_routes_local_solve_to_gmres(cuda):
    """K4's info != 0 on an indefinite L_Z sends the local solve to LGMRES
    (no exception, failure flagged), as a NaN Cholesky does in the JAX
    package; the CPU run takes the same route."""
    from ttipm_tpu_torch.solvers.local_kkt import ipm_local_solver

    out = {}
    for dev in ("cpu", cuda):
        K.reset_counts()
        out[str(dev)] = ipm_local_solver(*_local_system(dev, 3, 4, spd=False), 30)
        if dev != "cpu":
            assert K.STATS["panel_cholesky"].launches == 1
    assert out["cpu"][5] and out[str(cuda)][5]
    assert bool(torch.isfinite(out[str(cuda)][0]).all())
    assert out[str(cuda)][2] == pytest.approx(out["cpu"][2], rel=1e-6, abs=1e-12)


@pytest.mark.cuda
@_in_own_process
def test_cuda_block_local_product_is_one_k2_launch(cuda):
    """The ragged sweeps' block_local_product (five blocks and the (1,0)
    transpose: six terms) is one K2 launch and one device kernel."""
    XL, view, XR, _, _, _, x = _local_system(cuda, 5, 7)
    K.reset_counts()
    y = view.block_local_product(XL, XR, x)
    torch.cuda.synchronize()
    assert K.STATS["kkt_block_matvec"].launches == 1
    assert K.STATS["kkt_block_matvec"].grouped == 1
    names = _device_kernel_names(lambda: view.block_local_product(XL, XR, x))
    assert len(names) == 1, names
    check_kernel("kkt_block_matvec", (XL[0, 0], view[0, 0], XR[0, 0], x[:, 0]),
                 K.kkt_block_matvec(XL[0, 0], view[0, 0], XR[0, 0], x[:, 0]))
    assert tuple(y.shape) == tuple(x.shape)


@pytest.mark.cuda
def test_cuda_lobpcg_window_above_the_dense_gate(cuda):
    """The ragged eigensolver's LOBPCG (K2 matvecs) on a near-diagonal
    window of 512 with an interior eigenvector as warm start reaches the
    extremal eigenvalue on the card (tests/test_eigen.py:100)."""
    from ttipm_tpu_torch.solvers.eigen import lobpcg_window

    rng = np.random.RandomState(7)
    l = nm = 8
    eye = np.zeros((l, 1, l))
    eye[:, 0, :] = np.eye(l)
    diag = np.linspace(1.0, 2.0, nm)
    diag[3] = 0.1
    A_k = np.zeros((1, nm, nm, 1))
    A_k[0, :, :, 0] = np.diag(diag)
    coup = rng.randn(nm, nm) * 1e-9
    A_k[0, :, :, 0] += coup + coup.T
    x0 = np.zeros((l, nm, l))
    x0[0, 5, 0] = 1.0
    ops = tuple(torch.as_tensor(a, device=cuda) for a in (eye, A_k, eye))
    K.reset_counts()
    lam, _, _ = lobpcg_window("w1", ops, torch.as_tensor(x0, device=cuda), tol=1e-8,
                              maxiter=600)
    assert abs(lam - 0.1) < 1e-4
    assert K.STATS["kkt_block_matvec"].launches > 0
    assert all(s.plain_calls == 0 for s in K.STATS.values())


@pytest.mark.cuda
def test_cuda_fully_ragged_solve_matches_cpu(cuda):
    """``set_fused_kkt(False)``: maxcut d2 seed 11 through the ragged AMEn and
    the ragged eigensolver on the card (K1, K2, K4 launched, no plain
    version) against the CPU run: same iterations, <C, X> to 1e-6."""
    from ttipm_tpu_torch import config
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.maxcut import create_problem
    from ttipm_tpu_torch.ops import tt as T

    out = {}
    config.set_fused_kkt(False)
    try:
        for dev in ("cpu", cuda):
            rng = np.random.RandomState(11)
            obj, L, b, lag = create_problem(2, 1, device=dev, rng=rng)
            K.reset_counts()
            X, _, _, Z, info = tt_ipm({"y": T.tt_reshape(lag, (4, 4))}, obj, L, b,
                                      max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3,
                                      mals_restarts=2, rng=rng)
            out[str(dev)] = (info["num_iters"], T.tt_inner_prod(T.tt_reshape(obj, (2, 2)), X),
                             abs(T.tt_inner_prod(X, Z)))
    finally:
        config.set_fused_kkt(True)
    assert out[str(cuda)][0] == out["cpu"][0]
    assert out[str(cuda)][1] == pytest.approx(out["cpu"][1], rel=1e-6)
    assert out[str(cuda)][2] < 1e-3
    assert all(s.plain_calls == 0 for s in K.STATS.values())
    for name in ("schur_assemble", "kkt_block_matvec", "panel_cholesky"):
        assert K.STATS[name].launches > 0, name


def _ineq_group_operands(rng, dev, R, dtype=torch.float64):
    """The nine terms on four rows of an inequality block product (the
    (1,3) alias reads the identity block's operands against column 3) and a
    group of six Schur blocks, operator ranks unequal within both; the
    (1,0) term and its block are flipped / transposed views."""
    ranks = {"00": (3, 2), "01": (2, 4), "12": (1, 1), "21": (4, 3), "22": (2, 2),
             "31": (1, 2), "33": (5, 1)}

    def t(*shape):
        return _dev(rng, dev, *shape, dtype=dtype)

    x = t(R, 4, 4, R)
    op = {k: (t(R, s, R), t(s, 4, 4, S), t(R, S, R)) for k, (s, S) in ranks.items()}
    pl, A, pr = op["01"]
    t10 = (pl.permute(2, 1, 0), A.transpose(1, 2), pr.permute(2, 1, 0))
    terms = [(*op["00"], x[:, 0], 0), (*op["01"], x[:, 1], 0), (*t10, x[:, 0], 1),
             (*op["12"], x[:, 2], 1), (*op["21"], x[:, 1], 2), (*op["22"], x[:, 2], 2),
             (*op["12"], x[:, 3], 1), (*op["31"], x[:, 1], 3), (*op["33"], x[:, 3], 3)]
    blocks = [op["21"], t10, op["22"], op["31"], op["00"], op["33"]]
    return terms, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R", [5, 8, 16, 32])
@_in_own_process
def test_cuda_ineq_products_and_groups_match_plain(cuda, dtype, R):
    """K2 with the nine terms of an inequality block product and K1 with a
    group of six blocks of unequal operator ranks, each one launch and one
    device kernel, against their plain versions."""
    rng = np.random.RandomState(300 + R)
    terms, blocks = _ineq_group_operands(rng, cuda, R, dtype=dtype)
    K.reset_counts()
    y = K.kkt_block_product(terms, 4)
    B = K.schur_assemble_group(blocks)
    torch.cuda.synchronize()
    for name in ("kkt_block_matvec", "schur_assemble"):
        st = K.STATS[name]
        assert (st.launches, st.grouped, st.plain_calls) == (1, 1, 0)
    assert tuple(y.shape) == (R, 4, 4, R) and len(B) == 6
    check_kernel("kkt_block_product", (terms, 4), y)
    check_kernel("schur_assemble_group", (blocks,), B)
    assert len(_device_kernel_names(lambda: K.kkt_block_product(terms, 4))) == 1
    assert len(_device_kernel_names(lambda: K.schur_assemble_group(blocks))) == 1


@pytest.mark.cuda
def test_cuda_ragged_local_solver_ineq_matches_cpu(cuda):
    """The ragged inequality local KKT solve at its dense gate (sqrt(r R) <=
    24: r = 25, R = 23, m = 2300) on the card (one K1 group of six, K4 in
    its blocked regime, K2 applies) against the CPU run of the plain
    versions, and its LGMRES branch at r = 3, R = 2 (one K2 launch of six
    terms on three rows a matvec)."""
    from ttipm_tpu_torch.solvers.local_kkt import ipm_local_solver_ineq

    for dense, (r, R) in ((True, (25, 23)), (False, (3, 2))):
        out = {}
        for dev in ("cpu", cuda):
            K.reset_counts()
            out[str(dev)] = ipm_local_solver_ineq(*_local_system(dev, r, R, ineq=True), 30,
                                                  dense)
            if dev != "cpu":
                assert K.STATS["schur_assemble"].launches == (1 if dense else 0)
                assert K.STATS["panel_cholesky"].launches == (1 if dense else 0)
                assert K.STATS["kkt_block_matvec"].launches > 0
                assert all(s.plain_calls == 0 for s in K.STATS.values())
        sol_c, old_c, new_c, _, _, fail_c = out["cpu"]
        sol_g, old_g, new_g, _, _, fail_g = out[str(cuda)]
        assert fail_c == fail_g == (not dense)
        assert old_g == pytest.approx(old_c, rel=1e-9)
        assert float(torch.linalg.norm(sol_g.cpu() - sol_c)) <= 1e-8 * float(
            torch.linalg.norm(sol_c))
        assert new_g < 1e-5 and new_c < 1e-5


@pytest.mark.cuda
def test_cuda_corr_clust_solve_matches_cpu(cuda):
    """corr_clust d3 seed 291 (the inequality path: the IneqStatus machine,
    nine-term products, six-block groups, the min-eig step sizes) on the
    card against its CPU run: same iterations, ineq_status and X / T ranks,
    <C, X> to 1e-6, no plain version on a CUDA tensor."""
    from ttipm_tpu_torch.ipm import tt_ipm
    from ttipm_tpu_torch.models.corr_clust import create_problem
    from ttipm_tpu_torch.ops import tt as T

    out = {}
    for dev in ("cpu", cuda):
        rng = np.random.RandomState(291)
        obj, L, b, mask, lag = create_problem(3, 1, device=dev, rng=rng)
        K.reset_counts()
        X, _, Tm, Z, info = tt_ipm(lag, obj, L, b, ineq_mask=mask, max_iter=22, gap_tol=3e-4,
                                   op_tol=1e-4, abs_tol=1e-3, mals_restarts=2,
                                   lambdaStarIneq=1e-3, rng=rng)
        out[str(dev)] = (info["num_iters"], info["status"].ineq_status, info["ranksX"],
                         info["ranksT"], T.tt_inner_prod(T.tt_reshape(obj, (2, 2)), X),
                         abs(T.tt_inner_prod(X, Z)))
    assert out[str(cuda)][:4] == out["cpu"][:4]
    assert out[str(cuda)][4] == pytest.approx(out["cpu"][4], rel=1e-6)
    assert out[str(cuda)][5] < 1e-3
    assert all(s.plain_calls == 0 for s in K.STATS.values())
    assert all(s.launches > 0 for s in K.STATS.values())


class _Captured(BaseException):
    """Stops a solve once its first Newton system is built."""


def _first_graphm_system(dev):
    """The port's first Newton system of graphm n=2 seed 256 at
    configs/graphm_2.yaml's settings on ``dev``: (lhs, rhs, status)."""
    import ttipm_tpu_torch.ipm as ipm
    from ttipm_tpu_torch.models.graphm import create_problem
    from ttipm_tpu_torch.ops.tt import tt_reshape

    built, out = ipm.tt_infeasible_newton_system, {}

    def capture(*args):
        out["system"] = built(*args)
        raise _Captured()

    rng = np.random.RandomState(256)
    C, L, b, mask, lag = create_problem(2, 1, device=dev, rng=rng)
    lag = {k: tt_reshape(v, (4, 4)) for k, v in lag.items()}
    ipm.tt_infeasible_newton_system = capture
    try:
        with pytest.raises(_Captured):
            ipm.tt_ipm(lag, tt_reshape(C, (4,)), L, tt_reshape(b, (4,)), ineq_mask=mask,
                       max_iter=25, gap_tol=5e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                       mals_restarts=2, max_refinement=5, lambdaStar=1.0,
                       lambdaStarIneq=1e-8, rng=rng)
    finally:
        ipm.tt_infeasible_newton_system = built
    return out["system"]


def _dense_residual(lhs, rhs, x):
    """||A x - b|| / ||b|| of a block system, densely on the CPU."""
    from ttipm_tpu_torch.ops.tt import tt_matrix_to_matrix, tt_to_tensor
    from ttipm_tpu_torch.solvers.blocks import tt_get_block

    blocks = {k: tt_matrix_to_matrix([c.cpu() for c in v]) for k, v in lhs._data.items()}
    for src, dst in lhs._aliases.items():
        blocks[dst] = blocks[src]
    for src, dst in lhs._transposes.items():
        blocks[dst] = blocks[src].T
    n = next(iter(blocks.values())).shape[0]
    A = torch.zeros((4 * n, 4 * n), dtype=torch.float64)
    for (i, j), blk in blocks.items():
        A[i * n:(i + 1) * n, j * n:(j + 1) * n] = blk
    xd = torch.cat([tt_to_tensor([c.cpu() for c in tt_get_block(i, x)]).reshape(-1)
                    for i in range(4)])
    bd = torch.cat([tt_to_tensor([c.cpu() for c in rhs.get_row(i)]).reshape(-1)
                    for i in range(4)])
    return float(torch.linalg.norm(A @ xd - bd) / torch.linalg.norm(bd))


@pytest.mark.cuda
def test_cuda_graphm_first_newton_system(cuda, monkeypatch):
    """graphm n=2's first Newton system (the four-row inequality system)
    through the ragged AMEn with ``ipm_local_solver_ineq`` on the card and
    on the CPU: residual below the solver's tolerance (eta) in both, the
    card's K1, K2 and K4 launched, each kernel entry within its tolerance
    on the first call of every shape, no plain version on a CUDA tensor."""
    from ttipm_tpu_torch.checks import KERNEL_OF, kernel_errors, shape_key
    from ttipm_tpu_torch.solvers.amen import tt_restarted_block_amen
    from ttipm_tpu_torch.solvers.local_kkt import ipm_local_solver_ineq

    res = {}
    for dev in ("cpu", cuda):
        lhs, rhs, status = _first_graphm_system(dev)
        checked = {}
        if dev != "cpu":
            for name in KERNEL_OF:
                fn = getattr(K, name)

                def wrapped(*a, _fn=fn, _name=name, **kw):
                    out = _fn(*a, **kw)
                    key = (_name, shape_key(a))
                    if key not in checked:
                        checked[key] = kernel_errors(_name, a, out, cancelling=True)
                    return out
                monkeypatch.setattr(K, name, wrapped)
        K.reset_counts()
        x, _ = tt_restarted_block_amen(
            lhs, rhs, rank_restriction=status.mals_rank_restriction, op_tol=1e-4,
            termination_tol=status.eta, num_restarts=2, inner_m=status.kkt_iterations,
            local_solver=ipm_local_solver_ineq, rng=np.random.RandomState(256))
        monkeypatch.undo()
        res[str(dev)] = _dense_residual(lhs, rhs, x)
        assert res[str(dev)] <= status.eta
        if dev != "cpu":
            for name in ("schur_assemble", "kkt_block_matvec", "panel_cholesky"):
                assert K.STATS[name].launches > 0, name
            assert all(s.plain_calls == 0 for s in K.STATS.values())
            bad = {k: v for k, v in checked.items() if not v["ok"]}
            assert checked and not bad, bad


# ---------------------------------------------------------------------------
# Batches: the batched entries of K1-K4 (one call for B instances, the
# lockstep batched solve of parallel/fused_mesh.py).  Each instance is held
# against its plain version, and against a single call on it bit for bit
# (the same code in the same order); a batch of one equals the single call.
# ---------------------------------------------------------------------------

def _batch_group_operands(rng, dev, B, R, ranks, dtype):
    """``_group_operands`` with a leading batch axis of B: the third term
    and the second block flipped / transposed views, x strided columns of
    one block core, as the batched fused algebra hands them over."""
    def t(*shape):
        return _dev(rng, dev, B, *shape, dtype=dtype)

    x = t(R, 3, 4, R)
    ops = [(t(R, s, R), t(s, 4, 4, S), t(R, S, R)) for s, S in ranks]
    s, S = ranks[0]
    flipped = (t(R, s, R).permute(0, 3, 2, 1), t(s, 4, 4, S).transpose(2, 3),
               t(R, S, R).permute(0, 3, 2, 1))
    terms = [(*ops[0], x[:, :, 0], 0), (*ops[1], x[:, :, 1], 0), (*flipped, x[:, :, 0], 1),
             (*ops[2], x[:, :, 2], 1), (*ops[3], x[:, :, 1], 2), (*ops[4], x[:, :, 2], 2)]
    return terms, [ops[3], flipped, ops[4], ops[0]]


def _instance(group, i):
    return [tuple(t[i] if torch.is_tensor(t) else t for t in item) for item in group]


def _same_bits(a, b):
    return a.shape == b.shape and bool(torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("R", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 4, 9])
@pytest.mark.parametrize("B", [1, 5])
def test_cuda_batched_contractions(cuda, dtype, R, s, B):
    rng = np.random.RandomState(100 * R + s)
    ranks = [(s, s), (s + 1, s), (1, 1), (s, s + 2), (2, s)]
    terms, blocks = _batch_group_operands(rng, cuda, B, R, ranks, dtype)
    y = K.kkt_block_product_batch(terms, 3)
    G = K.schur_assemble_batch(blocks)
    assert y.shape == (B, R, 3, 4, R) and G.shape == (4, B, 4 * R * R, 4 * R * R)
    for i in range(B):
        ti, bi = _instance(terms, i), _instance(blocks, i)
        check_kernel("kkt_block_product", (ti, 3), y[i])
        check_kernel("schur_assemble_group", (bi,), list(G[:, i]))
        assert _same_bits(y[i], K.kkt_block_product(ti, 3))
        assert _same_bits(G[:, i], torch.stack(K.schur_assemble_group(bi)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mn", [(24, 6), (64, 18), (144, 36), (300, 20), (512, 128)])
@pytest.mark.parametrize("B", [1, 3])
def test_cuda_batched_panel_qr(cuda, dtype, mn, B):
    """Every regime: one CTA an instance up to 192 rows, a cluster of 2 or
    4 row slabs an instance above (with a workspace slice each)."""
    m, n = mn
    a = _dev(np.random.RandomState(m + n), cuda, B, n, m, dtype=dtype).transpose(1, 2)
    a[0, :, n // 2] = a[0, :, 0]  # a rank-deficient instance
    for transposed in (False, True):
        q, r = K.panel_qr_batch(a, transposed=transposed)
        assert q.is_contiguous() and q.shape == ((B, n, m) if transposed else (B, m, n))
        for i in range(B):
            qi = q[i].T if transposed else q[i]
            check_kernel("panel_qr", (a[i],), (qi, r[i]))
            q1, r1 = K.panel_qr(a[i], transposed=transposed)
            assert _same_bits(q[i], q1) and _same_bits(r[i], r1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n", [16, 144, 400, 1024])
@pytest.mark.parametrize("B", [1, 4])
def test_cuda_batched_panel_cholesky(cuda, dtype, n, B):
    """One CTA (n <= 160), a cluster of 8 (to 512) an instance, and the
    blocked regime launched once per instance; info per instance, an
    indefinite instance beside SPD ones."""
    a = torch.stack([_spd(n, cuda, seed=n + i, dtype=dtype) for i in range(B)])
    if B > 1:
        a[1, n // 3, n // 3] = -1.0
    a = a.transpose(1, 2)  # the lower triangle read through strides
    L, info = K.panel_cholesky_batch(a)
    assert L.shape == (B, n, n) and info.shape == (B,)
    for i in range(B):
        check_kernel("panel_cholesky", (a[i],), (L[i], info[i]))
        L1, info1 = K.panel_cholesky(a[i])
        assert int(info1) == int(info[i])
        if int(info1) == 0:
            assert _same_bits(L[i], L1)
    if B > 1:
        assert int(info[1]) == n // 3 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@_in_own_process
def test_cuda_batched_calls_are_one_launch(cuda, dtype):
    """A batched K1, K2, K3 (one CTA and cluster regimes) and resident K4
    call is one device kernel for all instances; the blocked K4 takes two
    an instance (the copy and the persistent kernel).  STATS counts each
    call once and its instances."""
    rng = np.random.RandomState(5)
    B = 5
    terms, blocks = _batch_group_operands(rng, cuda, B, 16, [(4, 4)] * 5, dtype)
    a = _dev(rng, cuda, B, 64, 18, dtype=dtype)
    a2 = _dev(rng, cuda, B, 300, 20, dtype=dtype)
    s1 = torch.stack([_spd(400, cuda, seed=i, dtype=dtype) for i in range(B)])
    s2 = torch.stack([_spd(1024, cuda, seed=i, dtype=dtype) for i in range(B)])
    calls = {"kkt_block_matvec": lambda: K.kkt_block_product_batch(terms, 3),
             "schur_assemble": lambda: K.schur_assemble_batch(blocks),
             "panel_qr": lambda: K.panel_qr_batch(a),
             "panel_qr_cluster": lambda: K.panel_qr_batch(a2, transposed=True),
             "panel_cholesky": lambda: K.panel_cholesky_batch(s1)}
    _device_kernel_names(calls["schur_assemble"])
    for name, call in calls.items():
        kernels = _device_kernel_names(call)
        assert len(kernels) == 1, (name, kernels)
        K.reset_counts()
        call()
        st = K.STATS[name.replace("_cluster", "")]
        assert (st.launches, st.batched, st.instances) == (1, 1, B), name
    kernels = _device_kernel_names(lambda: K.panel_cholesky_batch(s2))
    assert len(kernels) == 2 * B, kernels


@pytest.mark.cuda
def test_cuda_fused_batch_matches_cpu(cuda):
    """The lockstep batched fused solve and Newton step of three maxcut d6
    first Newton systems (configs/maxcut_6.yaml's first seeds) on the card
    through the batched kernels, against the same on the CPU: each
    instance's predictor residual within 10x of the CPU run's (the bound of
    tests/test_parallel.py:101) and the steps to 1e-5 (its bound for two
    runs of one batch); every kernel launched batched, no plain call."""
    from ttipm_tpu_torch.checks import first_newton_system, kkt_residual_norm
    from ttipm_tpu_torch.parallel.fused_mesh import (tt_block_amen_fused_batch,
                                                     tt_newton_step_batch)
    from ttipm_tpu_torch.utils.runner import load_yaml
    from ttipm_tpu_torch.solvers import fused as F

    seeds = (73, 54, 624)
    runs = {}
    for dev in ("cpu", cuda):
        cfg = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs",
                                     "maxcut_6.yaml"))
        inst = [first_newton_system("maxcut", cfg, s, dev) for s in seeds]
        systems = [i[:2] for i in inst]
        K.reset_counts()
        sols, _ = tt_block_amen_fused_batch([s[0] for s in systems], [s[1] for s in systems],
                                            R=8, ineq=False, term_tol=1e-6, nswp=8, seed=5)
        res = []
        for (lhs, rhs), x in zip(systems, sols):
            A, b = F.prep_operator(lhs), F.prep_rhs(rhs, 6, x[0])
            res.append(kkt_residual_norm(A, b, x) / rhs.norm)
        steps = tt_newton_step_batch(systems, [i[2] for i in inst], [i[3] for i in inst], R=8,
                                     seed=5)[:2]
        runs[str(dev)] = (res, steps, {n: (s.batched, s.plain_calls) for n, s in K.STATS.items()})
    (res_c, steps_c, _), (res_g, steps_g, counts) = runs["cpu"], runs[str(cuda)]
    for rg, rc in zip(res_g, res_c):
        assert rg < max(10 * rc, 1e-8), (res_g, res_c)
    for sg, sc in zip(steps_g, steps_c):
        assert np.all(np.abs(sg - sc) < 1e-5 * np.maximum(1.0, np.abs(sc))), (steps_g, steps_c)
    assert all(batched > 0 and plain == 0 for batched, plain in counts.values()), counts


# ---------------------------------------------------------------------------
# J1 / J2: the Jacobi cores of the SVD and eigh on the card, and the
# pipelines around them (ttipm_tpu_torch/ops/jacobi.py)
# ---------------------------------------------------------------------------

def _jacobi_gallery(n, rng):
    """Square operands of order n in the spirit of tests/test_jacobi.py's
    gallery: well conditioned, exact zero columns, columns scaled by 1e-15,
    a duplicated column, condition 1e14."""
    q1, _ = np.linalg.qr(rng.randn(n, n))
    q2, _ = np.linalg.qr(rng.randn(n, n))
    A = (q1 * np.logspace(0, -6, n)) @ q2.T
    Z = A.copy(); Z[:, (3 * n) // 4:] = 0.0
    T = A.copy(); T[:, (3 * n) // 4:] *= 1e-15
    D = A.copy(); D[:, -1] = D[:, 0]
    return {"well_cond": A, "zero_cols": Z, "tiny_cols": T, "dup_col": D,
            "cond_1e14": (q1 * np.logspace(0, -14, n)) @ q2.T, "random": rng.randn(n, n)}


def _sym_gallery(n, rng):
    q, _ = np.linalg.qr(rng.randn(n, n))
    half = n // 2
    specs = {"spread": np.linspace(-3, 5, n), "zero": np.zeros(n),
             "psd_tiny": np.r_[np.zeros(half), np.logspace(-14, 0, n - half)],
             "clustered": 1.0 + 1e-12 * rng.randn(n), "random": rng.randn(n)}
    out = {}
    for name, spec in specs.items():
        a = (q * spec) @ q.T
        out[name] = 0.5 * (a + a.T)
    return out


# J1's and J2's block regimes are held from the order from which J2's was
# measured faster than its element kernel (PERF.md), beside the regime
# each order takes under the shipped crossovers (kernels.J1_BLOCK_FROM,
# kernels.J2_BLOCK_FROM).
J2_BLOCK_TESTED_FROM = 24


@contextmanager
def _j1_block_from(n):
    """J1's regimes with the block regime from order n."""
    saved = K.J1_BLOCK_FROM
    K.J1_BLOCK_FROM = n
    K.j1_plan.cache_clear()
    try:
        yield
    finally:
        K.J1_BLOCK_FROM = saved
        K.j1_plan.cache_clear()


def _j1_crossovers(n):
    """The shipped crossover, and J2_BLOCK_TESTED_FROM where that moves
    order n into J1's block regime."""
    return [K.J1_BLOCK_FROM] + ([J2_BLOCK_TESTED_FROM]
                                if J2_BLOCK_TESTED_FROM <= n < K.J1_BLOCK_FROM else [])


# J1's cluster sizes change at 32 / 34, 64 / 66 and 96 / 98 (blocks of 16);
# 118 is the element regime's bound, 128 J1's.
J1_BOUNDARIES = (16, 24, 32, 34, 64, 66, 96, 98, 120, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted({2, 4, 6, 8, 42, 60, 118, *range(24, 129, 2)}))
def test_cuda_jacobi_orthogonalise_matches_plain(cuda, n):
    """J1 at the census's orders (the tall pipeline's r2^T: 4 from 8 x 4, 6
    from 64 x 6, 42 from 192 x 42, 60 from 80 x 60), the element regime's
    bound 118 and every even order of the block regime from 24 to J1's
    bound 128 (the cluster sizes' boundaries, ragged last blocks, empty
    ones), on the gallery, one batch of all cases plus a NaN instance, in
    the regime the shipped crossover gives each order and from 24 also in
    the block regime; at the cluster boundaries and 118 also in the element
    regime forced (to 118), each against the plain version of the order's
    regime (through its invariants)."""
    rng = np.random.RandomState(n)
    # the pipeline's operand: r2^T, r^T = q2 r2, r of the QR of the scaled matrix
    cases = [np.linalg.qr(np.linalg.qr(c / max(np.abs(c).max(), 1e-300))[1].T)[1].T
             for c in _jacobi_gallery(n, rng).values()]
    w = torch.as_tensor(np.stack(cases + [cases[0]]), device=cuda).contiguous()
    w[-1, 0, 0] = float("nan")
    for start in _j1_crossovers(n):
        with _j1_block_from(start):
            out = K.jacobi_orthogonalise(w)
            errs = check_kernel("jacobi_orthogonalise", (w,), out)
            assert errs["nonfinite"] == 1 and all(bool(torch.isnan(t[-1]).all()) for t in out)
    if (n in J1_BOUNDARIES or n == 118) and n <= K.J1_ELEMENT_MAX_N:
        out = K._j1_launch(w, plan=K.j1_plan(n, element=True))
        errs = check_kernel("jacobi_orthogonalise", (w,), out)
        assert errs["nonfinite"] == 1


@contextmanager
def _j2_block_from(n):
    """J2's regimes with the block regime from order n."""
    saved = K.J2_BLOCK_FROM
    K.J2_BLOCK_FROM = n
    K.j2_plan.cache_clear()
    try:
        yield
    finally:
        K.J2_BLOCK_FROM = saved
        K.j2_plan.cache_clear()


def _j2_crossovers(n):
    """The shipped crossover, and J2_BLOCK_TESTED_FROM where that moves
    order n into the block regime."""
    return [K.J2_BLOCK_FROM] + ([J2_BLOCK_TESTED_FROM]
                                if J2_BLOCK_TESTED_FROM <= n < K.J2_BLOCK_FROM else [])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 16, 22, 24, 32, 34, 64, 66, 96, 98, 128, 130, 136, 160, 162,
                               192, 194, 224, 226, 256, 258, 272])
def test_cuda_jacobi_eigh_core_matches_plain(cuda, n):
    """J2 against the plain version of its regime at the eigen windows'
    orders (4, 16, 64, 128, 256), at each side of the regime boundary of
    J2_BLOCK_TESTED_FROM (the element rule to 22, blocks of 16 from 24) and
    of every cluster size of the block regime (1 CTA to 32, 2 to 64, 3 to
    96, ... 8 to 256, 9 from 258, a non-portable cluster), at ragged last
    blocks (24, 34, 66, 98, 130, 136, 162, 194, 226, 258) and empty ones
    (34, 66, ..., 272), on the symmetric gallery plus a NaN instance; and
    without eigenvectors (eigvalsh), whose values keep the bits of the call
    with them.  Each order also in the regime the shipped crossover gives
    it."""
    rng = np.random.RandomState(n)
    cases = list(_sym_gallery(n, rng).values())
    a = torch.as_tensor(np.stack(cases + [cases[0]]), device=cuda)
    a[-1, 1, 0] = a[-1, 0, 1] = float("nan")
    for start in _j2_crossovers(n):
        with _j2_block_from(start):
            out = K.jacobi_eigh_core(a)
            errs = check_kernel("jacobi_eigh_core", (a,), out)
            assert errs["nonfinite"] == 1 and all(bool(torch.isnan(t[-1]).all()) for t in out)
            values = K.jacobi_eigh_core(a, vectors=False)
            assert values[1] is None
            check_kernel("jacobi_eigh_core", (a,), values)
            assert _same_bits(values[0], out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 256])
def test_cuda_jacobi_eigh_element_regime_at_block_orders(cuda, n):
    """The element regime forced at the block regime's orders (the timings'
    'element_ms', the kernel J2 was) against the element plain version."""
    from ttipm_tpu_torch.checks import kernel_errors
    from ttipm_tpu_torch.ops import jacobi

    rng = np.random.RandomState(n + 1)
    a = torch.as_tensor(np.stack(list(_sym_gallery(n, rng).values())[:3]), device=cuda)
    out = K._j2_launch(a, plan=K.j2_plan(n, element=True))
    errs = kernel_errors("jacobi_eigh_core", (a,), out)
    want = jacobi.eigh_core_plain(a)
    assert float((out[0] - want[0]).abs().max()) <= tolerance("jacobi_eigh_core", a.dtype) * \
        float(want[0].abs().max())
    assert errs["fact"] <= 1e-12 and errs["orth"] <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("core,n", [pytest.param("j2", n, id=str(n)) for n in (16, 64, 128, 272)] +
                         [pytest.param("j1", n, id=f"svd-{n}") for n in (16, 60, 118, 128)])
def test_cuda_jacobi_eigh_stamps(cuda, core, n):
    """The clock stamps of J2 (kernels.jacobi_eigh_stamps) and of J1
    (kernels.jacobi_svd_stamps) in the regime of the order, and J1's in
    both of its regimes where the element one takes the order: positive
    cycles in the parts every run has, and counts that agree with the
    sweeps (kernels.jacobi_sweeps) and the schedule (n - 1 steps a sweep;
    nb - 1 outer steps of 2 * 16 - 1 inner steps, but for the inner sweeps
    skipped as quiet, all of the last outer sweep's among them)."""
    from chip_smoke import jacobi_operand

    entry = "jacobi_eigh_core" if core == "j2" else "jacobi_orthogonalise"
    x = jacobi_operand(entry, 1, n, np.random.RandomState(n), cuda)
    if core == "j2":
        runs = [(K.jacobi_eigh_stamps(x), K.j2_plan(n), K.jacobi_sweeps(entry, x))]
    else:
        plans = [K.j1_plan(n)] + ([K.j1_plan(n, element=True), K.j1_plan(n, block=True)]
                                  if n <= K.J1_ELEMENT_MAX_N else [])
        runs = []
        for plan in plans:
            count = torch.empty((1,), dtype=torch.int32, device=cuda)
            K._j1_launch(x, count, plan=plan)
            runs.append((K.jacobi_svd_stamps(x, plan), plan, count))
    for st, plan, sweeps in runs:
        sweeps = int(sweeps[0])
        assert st["sweeps"] == sweeps and st["setup"] > 0 and st["store"] > 0
        if plan[0]:
            nb = -(-n // plan[0])
            nb += nb % 2
            assert st["outer_steps"] == sweeps * (nb - 1)
            assert st["inner_steps"] == (st["outer_steps"] - st["quiet_inner_sweeps"]) * \
                (2 * plan[0] - 1)
            assert st["quiet_inner_sweeps"] >= nb - 1  # the last outer sweep's (CTA 0's slot)
            assert 0 < st["inner_steps_rotating"] <= st["inner_steps"]
            assert st["inner_rotations"] > 0
            if core == "j2":
                assert st["column_dmma"] > 0 and st["barrier_2"] > 0
            else:
                assert st["gram"] > 0 and st["products"] > 0 and st["barrier"] > 0
        elif core == "j2":
            assert st["steps"] == sweeps * (n - 1) and st["rotations"] > 0 and st["update"] > 0
        else:
            assert st["steps"] == sweeps * (n - 1) and st["reductions"] > 0 and st["rotation"] > 0


@pytest.mark.cuda
def test_cuda_jacobi_instances_keep_their_bits_in_any_batch(cuda):
    """An instance of J1, J2 and of the whole SVD / eigh pipelines gets the
    same bits in a batch of five as alone (the pipelines' matrix products
    are cuBLAS's batched GEMM at every batch size); J2 at 128 in the
    regime of the order and in the block regime, and at 272 (a cluster of
    nine), with and without eigenvectors; J1 at 42 in the regime of the
    order and in the block regime, at 128 (a cluster of four) and an SVD of
    a 160 x 100 operand in the block regime."""
    from ttipm_tpu_torch.ops import linalg

    rng = np.random.RandomState(9)
    w = _dev(rng, cuda, 5, 42, 42)
    s = _dev(rng, cuda, 5, 128, 128)
    s = s + s.mT
    tall = _dev(rng, cuda, 5, 80, 60)
    wide = _dev(rng, cuda, 5, 16, 64)
    big = _dev(rng, cuda, 5, 272, 272)
    big = big + big.mT
    w128 = _dev(rng, cuda, 5, 128, 128)
    tall100 = _dev(rng, cuda, 5, 160, 100)
    calls = [K.jacobi_orthogonalise, K.jacobi_eigh_core, linalg.safe_svd, linalg.safe_svd,
             linalg.safe_eigh, K.jacobi_eigh_core,
             lambda x: K.jacobi_eigh_core(x, vectors=False)[:1], K.jacobi_orthogonalise,
             linalg.safe_svd]
    for start_j1 in _j1_crossovers(42):
        for start in _j2_crossovers(128):
            with _j2_block_from(start), _j1_block_from(start_j1):
                for fn, x in zip(calls, (w, s, tall, wide, s, big, big, w128, tall100)):
                    batch = fn(x)
                    for i in range(5):
                        single = fn(x[i:i + 1])
                        assert all(_same_bits(b[i:i + 1], t) for b, t in zip(batch, single)), \
                            (fn, i)


@pytest.mark.cuda
def test_cuda_jacobi_refuses_what_it_does_not_take(cuda):
    rng = np.random.RandomState(3)
    with pytest.raises(K.KernelError):
        K.jacobi_orthogonalise(_dev(rng, cuda, 2, 8, 8, dtype=torch.float32))
    with pytest.raises(K.KernelError):
        K.jacobi_eigh_core(_dev(rng, cuda, 2, 8, 8, dtype=torch.float32))
    with pytest.raises(K.KernelError):
        K.jacobi_orthogonalise(_dev(rng, cuda, 2, 7, 7))
    with pytest.raises(K.KernelError):
        K.jacobi_orthogonalise(_dev(rng, cuda, 1, K.J1_MAX_N + 2, K.J1_MAX_N + 2))
    with pytest.raises(K.KernelError):
        K.jacobi_eigh_core(_dev(rng, cuda, 1, K.J2_MAX_N + 2, K.J2_MAX_N + 2))
    with pytest.raises(K.KernelError):
        K.jacobi_eigh_core(_dev(rng, cuda, 6, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4), (64, 6), (80, 60), (192, 42), (8, 16), (15, 22),
                                   (600, 20), (9, 1), (1, 9), (300, 130)])
def test_cuda_jacobi_svd_pipeline(cuda, shape):
    """The SVD on a CUDA tensor goes through J1 (and K3 where the QR lies in
    its envelope): u @ diag(s) @ vt == a, u orthonormal, s against
    LAPACK's; launches counted, no plain call; (600, 20)'s QR and (300,
    130)'s whole SVD go to torch.linalg by the shape rule, counted."""
    from ttipm_tpu_torch.ops import jacobi, linalg

    m, n = shape
    a = _dev(np.random.RandomState(m + n), cuda, m, n)
    K.reset_counts()
    u, s, vt = linalg.safe_svd(a)
    k = min(m, n)
    inside = k + k % 2 <= K.J1_MAX_N
    assert K.STATS["jacobi_svd"].launches == int(inside)
    assert K.STATS["jacobi_svd"].outside == int(not inside)
    assert all(st.plain_calls == 0 for st in K.STATS.values())
    assert K.STATS["panel_qr"].outside == int(max(m, n) > 512 and inside)
    assert float(torch.linalg.norm((u * s) @ vt - a) / torch.linalg.norm(a)) < 1e-13
    assert float((u.T @ u - torch.eye(k, dtype=u.dtype, device=cuda)).abs().max()) < 1e-13
    s_ref = np.linalg.svd(a.cpu().numpy(), compute_uv=False)
    assert np.max(np.abs(s.cpu().numpy() - s_ref)) <= 1e-12 * s_ref[0]
    with jacobi.forced(False):
        K.reset_counts()
        linalg.safe_svd(a)
        assert K.STATS["jacobi_svd"].launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 7, 16, 64, 128, 255, 256])
def test_cuda_jacobi_eigh_pipeline(cuda, n):
    """eigh and eigvalsh on a CUDA tensor go through J2 (odd orders padded):
    V diag(w) V^T == A, V orthonormal, w against LAPACK's."""
    from ttipm_tpu_torch.ops import linalg

    a = _sym_gallery(n, np.random.RandomState(n))["spread"]
    at = torch.as_tensor(a, device=cuda)
    K.reset_counts()
    w, v = linalg.safe_eigh(at)
    w2 = linalg.safe_eigvalsh(at)
    assert K.STATS["jacobi_eigh"].launches == 2 and K.STATS["jacobi_eigh"].plain_calls == 0
    assert _same_bits(w, w2)
    eye = torch.eye(n, dtype=at.dtype, device=cuda)
    grow = max(1.0, n / 64)  # as tests/test_torch_jacobi.py: ~sweeps n rotations a column
    assert float(torch.linalg.norm(v @ torch.diag(w) @ v.T - at) / torch.linalg.norm(at)) < \
        1e-13 * grow
    assert float((v.T @ v - eye).abs().max()) < 1e-13 * grow
    w_ref = np.linalg.eigvalsh(a)
    assert np.max(np.abs(w.cpu().numpy() - w_ref)) <= 1e-12 * np.abs(w_ref).max()


# ---------------------------------------------------------------------------
# The whole-solve path: the programs' steps as CUDA graphs (solvers/graphs.py)
# ---------------------------------------------------------------------------

@contextmanager
def _whole_solve():
    from ttipm_tpu_torch import config
    from ttipm_tpu_torch.solvers import graphs

    config.set_fused_whole_solve(True)
    graphs.reset()
    try:
        yield graphs
    finally:
        config.set_fused_whole_solve(None)
        graphs.reset()


def _d5_system(dev):
    from ttipm_tpu_torch.checks import first_newton_system
    from ttipm_tpu_torch.utils.runner import load_yaml

    cfg = load_yaml(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "configs", "maxcut_5.yaml"))
    return first_newton_system("maxcut", cfg, cfg["seeds"][0], dev)


def _d5_pencil(X, dev):
    from ttipm_tpu_torch.ops import tt as T
    from ttipm_tpu_torch.ops.random import tt_random_gaussian

    Dl = tt_random_gaussian([2] * 4, (2, 2), device=dev, rng=np.random.RandomState(5))
    D = T.tt_add(T.tt_add(T.tt_scale(0.5, Dl), T.tt_scale(0.5, T.tt_transpose(Dl))),
                 T.tt_scale(-0.3, T.tt_identity(5, device=dev)))
    return T.tt_scale(1e-3, X), D  # indefinite along D within the unit step: the shrink rule


@pytest.mark.cuda
def test_cuda_whole_solve_graphs_match_eager_runs(cuda):
    """The whole-solve programs replayed from CUDA graphs against the same
    programs run eagerly on the card (graphs.eager()): bit for bit, on the
    first Newton system of maxcut d5 (term_tol and eps 0: all four pairs of
    nswp = 12) and on a d5 pencil that takes the shrink rule."""
    from ttipm_tpu_torch.solvers import fused as TF
    from ttipm_tpu_torch.solvers import fused_eigen as TE

    with _whole_solve() as graphs:
        lhs, rhs, X, _ = _d5_system(cuda)
        A, D = _d5_pencil(X, cuda)
        out = {}
        for mode in ("graphs", "eager", "replays"):
            with graphs.eager(mode == "eager"):
                x, res = TF.tt_block_amen_fused(lhs, rhs, 0.0, R=8, eps=0.0, nswp=12,
                                                rng=np.random.RandomState(0))
                step, v = TE.tt_max_generalised_eigen_fused(A, D, tol=1e-8,
                                                            rng=np.random.RandomState(0))
            out[mode] = (x, res, v, step)
        by_step = graphs.STATS.by_step
        assert by_step["fused_pair"]["captures"] == 1
        assert by_step["fused_pair"]["replays"] == 3 + 4  # the first run's three, the third's four
        assert by_step["fused_pair"]["forced_steps"] == 4
        assert by_step["gen_eigen_pair"]["replays"] >= 1
        assert graphs.STATS.eager_signatures == 0
        assert 0.0 < out["graphs"][3] < 1.0
        for mode in ("graphs", "replays"):
            x, res, v, step = out[mode]
            assert res == out["eager"][1] and step == out["eager"][3]
            assert all(torch.equal(a, b) for a, b in zip(x, out["eager"][0]))
            assert all(torch.equal(a, b) for a, b in zip(v, out["eager"][2]))


@pytest.mark.cuda
def test_cuda_whole_solve_capture_refuses_host_reads(cuda):
    """A step is captured under torch.cuda.set_sync_debug_mode("error"): a
    host read inside it raises at capture, and nothing falls back."""
    with _whole_solve() as graphs:
        x = torch.ones(4, device=cuda)
        with pytest.raises(RuntimeError):
            graphs.run(("read",), lambda a: a * float(a.sum()), x)
        assert graphs.STATS.captures == 0
        assert torch.cuda.get_sync_debug_mode() == 0
        out = graphs.run(("add",), lambda a: a + 1, x)   # a step without one is captured
        assert graphs.STATS.captures == 1 and torch.equal(out, x + 1)


@pytest.mark.cuda
def test_cuda_whole_solve_launch_counts_after_three_replays(cuda):
    """kernels.STATS counts what the card ran: a step's eager run counts its
    launches once, its capture nothing, each replay its launches again."""
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers import fused_eigen as TE
    from ttipm_tpu_torch.solvers import fused_eigen_batch as feb

    with _whole_solve() as graphs:
        _, _, X, _ = _d5_system(cuda)
        A, D = _d5_pencil(X, cuda)
        A_p, D_p = fb.batch_of_one(TE._prep_operator(A)), fb.batch_of_one(TE._prep_operator(D))
        caps = TE._vec_caps(5, 8, 2)
        xs = fb.batch_of_one(TE._prep_vec(None, 5, 2, caps, np.random.RandomState(0), A[0]))
        carry = feb._gen_start(A_p, D_p, xs, torch.ones(1, dtype=torch.float64, device=cuda),
                               1e-8, caps, selects=True)

        def pair(args):
            return feb._gen_pair(*args, 1e-8, caps, selects=True)

        K.reset_counts()
        with graphs.eager():
            graphs.run(("pair",), pair, (A_p, D_p, carry))
        once = {n: (s.launches, dict(s.by_regime)) for n, s in K.STATS.items()}
        assert once["jacobi_eigh"][0] > 0 and once["schur_assemble"][0] > 0
        K.reset_counts()
        for _ in range(4):                            # a capture, then three replays
            graphs.run(("pair",), pair, (A_p, D_p, carry))
        torch.cuda.synchronize()
        assert graphs.STATS.captures == 1 and graphs.STATS.replays == 3
        for n, (launches, regimes) in once.items():
            assert K.STATS[n].launches == 4 * launches
            assert K.STATS[n].by_regime == {k: 4 * v for k, v in regimes.items()}
