"""The port's four kernel wrappers (ttipm_tpu_torch/ops/kernels.py).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels run as its own tests run them
(``interpret=True``): f32 for the Schur assembly, the panel QR and the
panel Cholesky with the tolerances of tests/test_kernels.py, f64 for the
block matvec and for the Schur assembly's XLA path.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttipm_tpu.ops import kernels as JK
from ttipm_tpu_torch.checks import check_kernel
from ttipm_tpu_torch.ops import kernels as K


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("dims", [(5, 3, 4, 4, 4, 3, 5, 4), (3, 1, 6, 4, 4, 2, 2, 5)])
def test_kkt_block_matvec_plain_matches_pallas(dims):
    l, s, r, m, n, S, L, R = dims
    rng = np.random.RandomState(0)
    pl, A, pr, x = (rng.randn(l, s, r), rng.randn(s, m, n, S), rng.randn(L, S, R),
                    rng.randn(r, n, R))
    want = np.asarray(JK.kkt_block_matvec(*(jnp.asarray(t) for t in (pl, A, pr, x)),
                                          interpret=True))
    got = K.kkt_block_matvec(*(torch.as_tensor(t) for t in (pl, A, pr, x)))
    assert tuple(got.shape) == (l, m, L)
    assert rel(got.numpy(), want) < 1e-12


def test_schur_assemble_plain_matches_pallas():
    rng = np.random.RandomState(1)
    l = r = L = R = 8
    s = S = 6
    pl = rng.randn(l, s, r).astype(np.float32)
    A = rng.randn(s, 4, 4, S).astype(np.float32)
    pr = rng.randn(L, S, R).astype(np.float32)
    want = np.asarray(JK.schur_assemble(jnp.asarray(pl), jnp.asarray(A), jnp.asarray(pr),
                                        interpret=True))
    got = K.schur_assemble(torch.as_tensor(pl), torch.as_tensor(A), torch.as_tensor(pr))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    # f64 against the XLA path, including a 16-wide operator core (the
    # merged two-core window of the eigensolver)
    for shape_a in ((3, 4, 4, 2), (2, 16, 16, 3)):
        pl = rng.randn(5, shape_a[0], 5)
        A = rng.randn(*shape_a)
        pr = rng.randn(3, shape_a[-1], 3)
        want = np.asarray(JK.schur_assemble_xla(jnp.asarray(pl), jnp.asarray(A), jnp.asarray(pr)))
        got = K.schur_assemble(torch.as_tensor(pl), torch.as_tensor(A), torch.as_tensor(pr))
        assert rel(got.numpy(), want) < 1e-12


@pytest.mark.parametrize("mn", [(32, 8), (48, 12), (7, 3), (16, 16)])
def test_panel_qr_plain_matches_pallas(mn):
    m, n = mn
    a = np.random.RandomState(m).randn(m, n).astype(np.float32)
    qj, rj = (np.asarray(t) for t in JK.panel_qr(jnp.asarray(a), interpret=True))
    q, r = (t.numpy() for t in K.panel_qr(torch.as_tensor(a)))
    scale = np.abs(a).max()
    assert np.abs(q @ r - a).max() < 5e-6 * scale * max(m, n) ** 0.5
    assert np.abs(q.T @ q - np.eye(n)).max() < 5e-6 * n
    assert np.abs(np.tril(r, -1)).max() == 0.0
    # the same factors up to column signs (the Pallas kernel reflects a
    # column that is already reduced, LAPACK leaves it)
    dj, d = np.sign(np.diag(rj)), np.sign(np.diag(r))
    assert np.abs(q * d - qj * dj).max() < 1e-4
    assert np.abs(d[:, None] * r - dj[:, None] * rj).max() < 1e-4 * scale


@pytest.mark.parametrize("n", [4, 12, 32, 96])
def test_panel_cholesky_plain_matches_pallas(n):
    rng = np.random.RandomState(n)
    B = rng.randn(n, n).astype(np.float32)
    A = B @ B.T + n * np.eye(n, dtype=np.float32)
    Lj = np.asarray(JK.panel_cholesky(jnp.asarray(A), interpret=True))
    L, info = K.panel_cholesky(torch.as_tensor(A))
    assert int(info) == 0
    L = L.numpy()
    assert np.allclose(L, np.tril(L))
    assert np.linalg.norm(L @ L.T - A) / np.linalg.norm(A) < 5e-6
    assert np.abs(L - Lj).max() < 1e-3 * np.abs(Lj).max()


def test_panel_cholesky_reports_failure():
    rng = np.random.RandomState(3)
    B = rng.randn(20, 20)
    A = B @ B.T + 20 * np.eye(20)
    A[7, 7] = -1.0
    _, info = K.panel_cholesky(torch.as_tensor(A))
    assert int(info) == 8  # 1-based order of the first failing minor


@pytest.mark.parametrize("shape", [(3, 4), (2, 3, 3), (4,)])
def test_panel_cholesky_takes_one_square_matrix(shape):
    """K4 factors a single square matrix: anything else is refused on every
    device, before any kernel is built and without a plain call."""
    K.reset_counts()
    with pytest.raises(K.KernelError):
        K.panel_cholesky(torch.zeros(shape, dtype=torch.float64))
    assert (K.STATS["panel_cholesky"].launches, K.STATS["panel_cholesky"].plain_calls) == (0, 0)


def test_panel_cholesky_bounds_match_the_cuda_source():
    """The wrapper's resident bound and panel width (which size the blocked
    regime's workspace) are the constants of csrc/panel_cholesky.cu."""
    import os
    import re

    from ttipm_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "panel_cholesky.cu")) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kResidentMaxN"]) == K.K4_RESIDENT_MAX_N
    assert int(consts["kNB"]) == K.K4_PANEL


def test_panel_cholesky_plain_reads_any_strides():
    """On the CPU a transposed view gives the plain factor of the matrix it
    shows (the CUDA kernel reads strides too; tests/test_torch_cuda.py)."""
    rng = np.random.RandomState(8)
    B = rng.randn(12, 12)
    A = torch.as_tensor(B @ B.T + 12 * np.eye(12))
    L, info = K.panel_cholesky(A.T)
    assert int(info) == 0
    np.testing.assert_allclose((L @ L.T).numpy(), A.numpy(), rtol=0, atol=1e-12)


def test_wrappers_count_plain_calls_on_cpu():
    K.reset_counts()
    rng = np.random.RandomState(4)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    K.kkt_block_matvec(t(2, 1, 3), t(1, 4, 4, 1), t(2, 1, 3), t(3, 4, 3))
    K.schur_assemble(t(2, 1, 3), t(1, 4, 4, 1), t(2, 1, 3))
    K.panel_qr(t(8, 3))
    K.panel_cholesky(torch.eye(5, dtype=torch.float64))
    for name, stats in K.STATS.items():
        assert (stats.launches, stats.plain_calls) == (0, 1), name


def test_wrappers_reject_other_devices():
    a = torch.empty((8, 3), dtype=torch.float64, device="meta")
    with pytest.raises(K.KernelError):
        K.panel_qr(a)
    with pytest.raises(K.KernelError):
        K.schur_assemble(torch.zeros(2, 1, 3, dtype=torch.float64),
                         torch.zeros(1, 4, 4, 1, dtype=torch.float64, device="meta"),
                         torch.zeros(2, 1, 3, dtype=torch.float64))


def _check_cases(rng):
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    B = t(24, 24)
    return {
        "kkt_block_matvec": (t(3, 2, 5), t(2, 4, 4, 3), t(6, 3, 4), t(5, 4, 4)),
        "schur_assemble": (t(3, 2, 5), t(2, 16, 16, 3), t(6, 3, 4)),
        "panel_qr": (t(24, 6),),
        "panel_cholesky": (B @ B.T + 24 * torch.eye(24, dtype=torch.float64),),
    }


@pytest.mark.parametrize("name", sorted(K.STATS))
def test_check_kernel_accepts_plain_and_rejects_perturbed(name):
    """The shared acceptance check (chip_smoke.py and the CUDA tests) passes
    the wrapper's own output and refuses one perturbed past its tolerance,
    without moving the wrapper's counters."""
    args = _check_cases(np.random.RandomState(5))[name]
    out = getattr(K, name)(*args)
    K.reset_counts()
    errs = check_kernel(name, args, out)
    assert errs.get("max_abs_err", 0.0) == 0.0
    assert all((s.launches, s.plain_calls) == (0, 0) for s in K.STATS.values())
    if name == "panel_qr":
        bad = (out[0], out[1] + 1e-9 * torch.tril(torch.ones_like(out[1])))
    elif name == "panel_cholesky":
        bad = (out[0] * (1 + 1e-9), out[1])
    else:
        bad = out * (1 + 1e-9)
    with pytest.raises(AssertionError):
        check_kernel(name, args, bad)
    if name == "panel_cholesky":
        with pytest.raises(AssertionError):
            check_kernel(name, args, (out[0], out[1] + 3))


def test_check_kernel_scales_cancelling_contractions():
    """On the solver's operands (``cancelling=True``) a block matvec is held
    to the scale of its terms: a result that cancels to 1e-12 of its terms
    may carry a rounding error of 1e-15 of them, and no more."""
    rng = np.random.RandomState(6)
    t = lambda *s: torch.as_tensor(rng.randn(*s))  # noqa: E731
    pl, A, pr, x = t(3, 1, 5), t(1, 4, 4, 1), t(6, 1, 4), t(5, 4, 4)
    args = (torch.cat([pl, pl], 1), torch.cat([A, -A * (1 + 1e-12)], 0), pr, x)
    y1 = K.kkt_block_matvec_plain(pl, A, pr, x)
    out = K.kkt_block_matvec_plain(*args) + 1e-15 * y1
    errs = check_kernel("kkt_block_matvec", args, out, cancelling=True)
    assert errs["rel_terms"] <= 1e-15 < 1e-4 < errs["rel"]
    with pytest.raises(AssertionError):
        check_kernel("kkt_block_matvec", args, out)
    with pytest.raises(AssertionError):
        check_kernel("kkt_block_matvec", args, out + 1e-9 * y1, cancelling=True)
