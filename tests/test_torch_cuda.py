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
non-contiguous operands, one kernel launch up to order 512).
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
    from torch.profiler import ProfilerActivity, profile

    A = _spd(n, cuda)
    K.panel_cholesky(A)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.panel_cholesky(A)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if n <= K.K4_RESIDENT_MAX_N:
        assert len(kernels) == 1, [e.name for e in kernels]
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
