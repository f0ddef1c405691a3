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
"""

import numpy as np
import pytest
import torch

from ttipm_tpu_torch.checks import check_kernel
from ttipm_tpu_torch.ops import kernels as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _dev(rng, dev, *shape):
    return torch.as_tensor(rng.randn(*shape), device=dev)


def _device_kernel_names(fn):
    """Names of the device kernels of one call of ``fn`` (torch.profiler).
    A trace now and then comes back empty, a process's first one more
    often: the call is traced again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("R", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 4, 9])
def test_cuda_contractions_match_plain(cuda, R, s):
    rng = np.random.RandomState(R + s)
    pl, A, pr = _dev(rng, cuda, R, s, R), _dev(rng, cuda, s, 4, 4, s), _dev(rng, cuda, R, s, R)
    x = _dev(rng, cuda, R, 4, R)
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
@pytest.mark.parametrize("shapes", ODD_CONTRACTIONS)
def test_cuda_contractions_odd_shapes(cuda, shapes):
    rng = np.random.RandomState(sum(map(sum, shapes)))
    pl, A, pr = (_dev(rng, cuda, *sh) for sh in shapes)
    x = _dev(rng, cuda, shapes[0][2], shapes[1][2], shapes[2][2])
    check_kernel("kkt_block_matvec", (pl, A, pr, x), K.kkt_block_matvec(pl, A, pr, x))
    check_kernel("schur_assemble", (pl, A, pr), K.schur_assemble(pl, A, pr))


def _group_operands(rng, dev, left, right, ranks, m=4):
    """A block product's six terms and a group of four Schur blocks on
    interfaces (l, s, r) / (L, S, R) with the outer dims ``left = (l, r)``,
    ``right = (L, R)`` and per-block operator ranks ``ranks``; the third
    term and second block are flipped / transposed views."""
    (l, r), (L, R) = left, right
    x = _dev(rng, dev, r, 3, m, R)
    ops = [(_dev(rng, dev, l, s, r), _dev(rng, dev, s, m, m, S), _dev(rng, dev, L, S, R))
           for s, S in ranks]
    s, S = ranks[0]
    flipped = (_dev(rng, dev, r, s, l).permute(2, 1, 0),
               _dev(rng, dev, s, m, m, S).transpose(1, 2),
               _dev(rng, dev, R, S, L).permute(2, 1, 0))
    assert not any(t.is_contiguous() for t in flipped) or min(l, r, L, R, s, S) == 1
    terms = [(*ops[0], x[:, 0], 0), (*ops[1], x[:, 1], 0), (*flipped, x[:, 0], 1),
             (*ops[2], x[:, 2], 1), (*ops[3], x[:, 1], 2), (*ops[4], x[:, 2], 2)]
    return terms, [ops[3], flipped, ops[4], ops[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [8, 16, 32])
@pytest.mark.parametrize("s", [1, 4, 9])
def test_cuda_grouped_contractions_match_plain(cuda, R, s):
    rng = np.random.RandomState(100 + R + s)
    ranks = [(s, s), (s + 1, s), (1, 1), (s, s + 2), (2, s)]
    terms, blocks = _group_operands(rng, cuda, (R, R), (R, R), ranks)
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
@pytest.mark.parametrize("shapes", ODD_CONTRACTIONS)
def test_cuda_grouped_contractions_odd_shapes(cuda, shapes):
    (l, s, r), (_, m, _, S), (L, _, R) = shapes
    rng = np.random.RandomState(7 + sum(map(sum, shapes)))
    ranks = [(s, S), (S, s), (1, 2), (s + 3, 1), (2, S + 1)]
    terms, blocks = _group_operands(rng, cuda, (l, r), (L, R), ranks, m=m)
    check_kernel("kkt_block_product", (terms, 3), K.kkt_block_product(terms, 3))
    check_kernel("schur_assemble_group", (blocks,), K.schur_assemble_group(blocks))
    check_kernel("schur_assemble_group", (blocks[:2],), K.schur_assemble_group(blocks[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(36, 100, 36, 4, 4, 100, 36, 36), (3, 40, 5, 16, 16, 30, 4, 6),
                                  (70, 2, 3, 4, 4, 2, 3, 3)])
def test_cuda_kkt_block_matvec_tiled_and_chunked(cuda, dims):
    """Operator ranks that force tiles of R, a wide physical index, and
    more values of l than the grid has chunks."""
    l, s, r, m, n, S, L, R = dims
    rng = np.random.RandomState(sum(dims))
    args = (_dev(rng, cuda, l, s, r), _dev(rng, cuda, s, m, n, S), _dev(rng, cuda, L, S, R),
            _dev(rng, cuda, r, n, R))
    check_kernel("kkt_block_matvec", args, K.kkt_block_matvec(*args))


@pytest.mark.cuda
def test_cuda_schur_assemble_rebuilds_w_for_huge_operator_rank(cuda):
    """S beyond the resident chunk of W: the slice is rebuilt per column tile."""
    rng = np.random.RandomState(5)
    args = (_dev(rng, cuda, 3, 2, 5), _dev(rng, cuda, 2, 4, 4, 2000), _dev(rng, cuda, 9, 2000, 9))
    assert K.k1_tiles((K._dims("schur_assemble", args),))[1] < 2000
    check_kernel("schur_assemble", args, K.schur_assemble(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("R,s", [(8, 4), (32, 9)])
def test_cuda_contractions_are_one_device_kernel(cuda, R, s):
    """Exactly one device kernel per K1 / K2 call, single or grouped, on
    contiguous and on flipped operands: no GEMM, copy or elementwise
    kernel from inside the wrappers; and one wrapper call per block
    product of the fused algebra."""
    from ttipm_tpu_torch.solvers import fused_algebra as fa

    rng = np.random.RandomState(R)
    ranks = [(s, s), (s + 1, s), (1, 1), (s, s + 2), (2, s)]
    terms, blocks = _group_operands(rng, cuda, (R, R), (R, R), ranks)
    keys = ("00", "01", "12", "21", "22")
    pl = {k: _dev(rng, cuda, R, s, R) for k in keys + ("10",)}
    pr = {k: _dev(rng, cuda, R, s, R) for k in keys + ("10",)}
    A = {k: _dev(rng, cuda, s, 4, 4, s) for k in keys}
    x = _dev(rng, cuda, R, 3, 4, R)
    calls = {
        "kkt_block_product": lambda: K.kkt_block_product(terms, 3),
        "kkt_block_matvec": lambda: K.kkt_block_matvec(*terms[2][:4]),
        "schur_assemble_group": lambda: K.schur_assemble_group(blocks),
        "schur_assemble": lambda: K.schur_assemble(*blocks[1]),
        "apply_T": lambda: fa.apply_T(pl["01"], A["01"], pr["01"], x[:, 0]),
        "local_product": lambda: fa.local_product(pl, A, pr, x),
        "z_product": lambda: fa.z_product(pl, A, pr, x),
        "mixed_product": lambda: fa.mixed_product(pl, pr, A, x, True),
        "mixed_product_left": lambda: fa.mixed_product(pl, pr, A, x, False),
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
@pytest.mark.parametrize("R", [8, 16, 32])
def test_cuda_panel_qr_contract(cuda, R):
    a = _dev(np.random.RandomState(R), cuda, 4 * R, R + 2)
    K.reset_counts()
    q, r = K.panel_qr(a)
    torch.cuda.synchronize()
    assert K.STATS["panel_qr"].launches == 1
    check_kernel("panel_qr", (a,), (q, r))


@pytest.mark.cuda
@pytest.mark.parametrize("mn", [(24, 6), (16, 6), (40, 10), (16, 10), (5, 5), (33, 1),
                                (100, 34)])
def test_cuda_panel_qr_odd_shapes(cuda, mn):
    a = _dev(np.random.RandomState(sum(mn)), cuda, *mn)
    check_kernel("panel_qr", (a,), K.panel_qr(a))
    if mn[1] > 2:  # rank-deficient: a repeated and a zero column
        a[:, 1] = a[:, 0]
        a[:, 2] = 0.0
        check_kernel("panel_qr", (a,), K.panel_qr(a))


# K3's panels: the smoke test's list; the boundaries of its regimes (1, 2,
# 4 or 6 rows a lane; one CTA up to 192 rows, a cluster of 2 up to 384, of 4
# above); square panels, single columns, row counts that are no multiple
# of 32 or of the cluster.
K3_PANELS = [(24, 6), (40, 10), (32, 10), (64, 18), (128, 34), (144, 36), (512, 32), (512, 128),
             (32, 8), (33, 8), (64, 8), (65, 8), (128, 8), (129, 8), (192, 20), (193, 20),
             (384, 57), (385, 57), (300, 128), (511, 127), (257, 3),
             (5, 5), (36, 36), (128, 128), (1, 1), (33, 1), (512, 1), (100, 34), (257, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("mn", K3_PANELS)
def test_cuda_panel_qr_envelope(cuda, mn):
    """The contract at every regime, with LAPACK's signs on the full-rank
    panel, then with a repeated and a zero column, then all zeros."""
    m, n = mn
    a = _dev(np.random.RandomState(m + n), cuda, m, n)
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
@pytest.mark.parametrize("mn", [(40, 10), (128, 34), (144, 36), (300, 20), (512, 128)])
def test_cuda_panel_qr_layouts(cuda, mn):
    """Transposed and strided operands are read in place; the transposed
    output is the contiguous (n, m) array q^T with the same bits as q."""
    m, n = mn
    rng = np.random.RandomState(m)
    a = _dev(rng, cuda, m, n)
    q, r = K.panel_qr(a)
    qt, rt = K.panel_qr(a, transposed=True)
    assert tuple(qt.shape) == (n, m) and qt.is_contiguous()
    assert torch.equal(qt, q.T) and torch.equal(rt, r)
    for view in (_dev(rng, cuda, n, m).T, _dev(rng, cuda, 2 * m, 2 * n)[::2, ::2]):
        assert not view.is_contiguous()
        got = K.panel_qr(view)
        check_kernel("panel_qr", (view,), got)
        same = K.panel_qr(view.contiguous())
        assert torch.equal(got[0], same[0]) and torch.equal(got[1], same[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mn", [(40, 10), (300, 20), (512, 100)])
def test_cuda_panel_qr_nan_comes_out_as_nan(cuda, mn):
    a = _dev(np.random.RandomState(3), cuda, *mn)
    a[3, 4] = float("nan")
    q, r = K.panel_qr(a)
    torch.cuda.synchronize()  # no hang: no loop of the kernel depends on the data
    assert bool(torch.isnan(q).any()) and bool(torch.isnan(r).any())


@pytest.mark.cuda
@pytest.mark.parametrize("mn", [(513, 10), (512, 129), (3, 5)])
def test_cuda_panel_qr_refuses_outside_the_envelope(cuda, mn):
    K.reset_counts()
    with pytest.raises(K.KernelError):
        K.panel_qr(torch.zeros(mn, dtype=torch.float64, device=cuda))
    assert (K.STATS["panel_qr"].launches, K.STATS["panel_qr"].plain_calls) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mn", [(24, 6), (40, 10), (128, 34), (144, 36), (512, 32), (512, 128)])
def test_cuda_panel_qr_is_one_device_kernel(cuda, mn):
    """One device kernel a call, in every regime and for either output
    layout and a transposed operand: no copy or elementwise kernel from
    inside the wrapper."""
    a = _dev(np.random.RandomState(1), cuda, *mn)
    at = _dev(np.random.RandomState(2), cuda, mn[1], mn[0]).T
    for call in (lambda: K.panel_qr(a), lambda: K.panel_qr(a, transposed=True),
                 lambda: K.panel_qr(at)):
        names = _device_kernel_names(call)
        assert len(names) == 1 and "panel_qr" in names[0], names
        assert not any(w in names[0].lower() for w in ("gemm", "copy", "elementwise")), names


@pytest.mark.cuda
def test_cuda_backward_split_takes_q_transposed_without_a_copy(cuda):
    """The K3 site of bck_split_step is one device kernel: the core is a
    view of the kernel's q^T.  Against a K3 that hands back q for the caller
    to transpose, the step runs fewer device kernels and gives the same
    core."""
    from ttipm_tpu_torch.solvers import fused_algebra as fa

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

    def solve_local(pl, A, pr, bl, b, br, x):
        z = x.new_zeros(())
        return 0.5 * x + 0.1 * torch.roll(x, 1, dims=2), None, z, z, z

    def step():
        return fa.bck_split_step(solve_local, pl, A, pr, bl, b, br, zl, zr, zbl, zbr,
                                 x_k, x_nb, z_k, z_nb, 8, 2, True)

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
@pytest.mark.parametrize("R", [8, 16, 32])
def test_cuda_panel_cholesky_contract(cuda, R):
    n = 4 * R * R
    B = _dev(np.random.RandomState(R), cuda, n, n)
    A = B @ B.T + n * torch.eye(n, dtype=B.dtype, device=cuda)
    check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    A[n // 3, n // 3] = -1.0
    errs = check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    assert errs["info"] == n // 3 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 5, 16, 24, 33, 40, 96, 100, 144, 400])
def test_cuda_panel_cholesky_odd_orders(cuda, n):
    B = _dev(np.random.RandomState(n), cuda, n, n)
    A = B @ B.T + n * torch.eye(n, dtype=B.dtype, device=cuda)
    check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    A[n - 1, n - 1] = -1.0
    errs = check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))
    assert errs["info"] == n


def _spd(n, dev, seed=None):
    B = _dev(np.random.RandomState(n if seed is None else seed), dev, n, n)
    return B @ B.T + n * torch.eye(n, dtype=B.dtype, device=dev)


# K4's regime and tile boundaries: one CTA up to 160, a cluster up to 512
# (the resident bound), 64-wide panels above; 32-wide tiles inside.
K4_BOUNDARY_ORDERS = [1, 31, 32, 33, 63, 64, 65, 159, 160, 161, 511, 512, 513,
                      575, 576, 577, 5184]


@pytest.mark.cuda
@pytest.mark.parametrize("n", K4_BOUNDARY_ORDERS)
def test_cuda_panel_cholesky_regime_boundaries(cuda, n):
    A = _spd(n, cuda)
    L, info = K.panel_cholesky(A)
    torch.cuda.synchronize()
    check_kernel("panel_cholesky", (A,), (L, info))
    assert float(torch.triu(L, 1).abs().max()) == 0.0


# (order, 0-based failing pivot): first and last panel of each regime
K4_FAILING_PIVOTS = [(144, 3), (144, 140), (400, 5), (400, 399), (1000, 10), (1000, 999)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", K4_FAILING_PIVOTS)
def test_cuda_panel_cholesky_failing_pivot(cuda, n, p):
    """info is the 1-based order of the first failing pivot (K4's contract;
    cholesky_ex on the card misses some negative last pivots, so the
    order is asserted, not compared with it)."""
    A = _spd(n, cuda)
    A[p, p] = -1.0
    _, info = K.panel_cholesky(A)
    assert int(info) == p + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(144, 70), (400, 200), (1000, 500)])
def test_cuda_panel_cholesky_nan_pivot(cuda, n, p):
    A = _spd(n, cuda)
    A[p, p] = float("nan")
    _, info = K.panel_cholesky(A)
    assert int(info) == p + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 400, 1000])
def test_cuda_panel_cholesky_reads_only_the_lower_triangle(cuda, n):
    A = _spd(n, cuda)
    iu = torch.triu_indices(n, n, 1, device=cuda)
    A[iu[0], iu[1]] = float("nan")
    L, info = K.panel_cholesky(A)
    check_kernel("panel_cholesky", (A,), (L, info))
    assert bool(torch.isfinite(L).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 400, 700])
def test_cuda_panel_cholesky_non_contiguous(cuda, n):
    big = _spd(2 * n, cuda)
    for A in (big[::2, ::2], big[:n, :n].T):  # strided and transposed views
        assert not A.is_contiguous()
        check_kernel("panel_cholesky", (A,), K.panel_cholesky(A))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 144, 256, 400, 512, 4096])
def test_cuda_panel_cholesky_launch_count(cuda, n):
    """One device kernel for every order up to 512; above it at most
    2 ceil(n / 64) + 2 (it takes two: a copy and one persistent kernel)."""
    A = _spd(n, cuda)
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


def _ineq_group_operands(rng, dev, R):
    """The nine terms on four rows of an inequality block product (the
    (1,3) alias reads the identity block's operands against column 3) and a
    group of six Schur blocks, operator ranks unequal within both; the
    (1,0) term and its block are flipped / transposed views."""
    ranks = {"00": (3, 2), "01": (2, 4), "12": (1, 1), "21": (4, 3), "22": (2, 2),
             "31": (1, 2), "33": (5, 1)}
    x = _dev(rng, dev, R, 4, 4, R)
    op = {k: (_dev(rng, dev, R, s, R), _dev(rng, dev, s, 4, 4, S), _dev(rng, dev, R, S, R))
          for k, (s, S) in ranks.items()}
    pl, A, pr = op["01"]
    t10 = (pl.permute(2, 1, 0), A.transpose(1, 2), pr.permute(2, 1, 0))
    terms = [(*op["00"], x[:, 0], 0), (*op["01"], x[:, 1], 0), (*t10, x[:, 0], 1),
             (*op["12"], x[:, 2], 1), (*op["21"], x[:, 1], 2), (*op["22"], x[:, 2], 2),
             (*op["12"], x[:, 3], 1), (*op["31"], x[:, 1], 3), (*op["33"], x[:, 3], 3)]
    blocks = [op["21"], t10, op["22"], op["31"], op["00"], op["33"]]
    return terms, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("R", [5, 8, 16, 32])
def test_cuda_ineq_products_and_groups_match_plain(cuda, R):
    """K2 with the nine terms of an inequality block product and K1 with a
    group of six blocks of unequal operator ranks, each one launch and one
    device kernel, against their plain versions."""
    rng = np.random.RandomState(300 + R)
    terms, blocks = _ineq_group_operands(rng, cuda, R)
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
