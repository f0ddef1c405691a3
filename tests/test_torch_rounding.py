"""Parity of the port's TT rounding with the JAX package, at rank bucket 1
(exact reference ranks) and 4 (the default, padded bonds).

Inputs are numpy cores from a seeded RandomState fed to both packages.
Dense values must agree to 1e-10 relative and TT ranks exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ttipm_tpu.ops.rounding as JR
import ttipm_tpu.ops.tt as J
import ttipm_tpu_torch.ops.rounding as TR
import ttipm_tpu_torch.ops.tt as T
from ttipm_tpu import config as jconfig
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.interop import tt_to_torch

TOL = 1e-10


@pytest.fixture(params=[1, 4], ids=["bucket1", "bucket4"])
def bucket(request):
    jconfig.set_rank_bucket(request.param)
    tconfig.set_rank_bucket(request.param)
    yield request.param
    jconfig.set_rank_bucket(1)
    tconfig.set_rank_bucket(4)


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def noisy_low_rank(rng, d, rank, noise):
    """Matrix train of rank ``rank`` plus a small rank-2 perturbation."""
    def train(r):
        ranks = [1] + [r] * (d - 1) + [1]
        return [rng.standard_normal((ranks[k], 2, 2, ranks[k + 1])) for k in range(d)]

    base, pert = train(rank), train(2)
    pert[0] = pert[0] * noise
    out = J.tt_add([jnp.asarray(c) for c in base], [jnp.asarray(c) for c in pert])
    return [np.asarray(c) for c in out]


def both(cores):
    return [jnp.asarray(c) for c in cores], tt_to_torch(cores, device="cpu")


def check(tt_, tj, tol=TOL):
    assert T.tt_ranks(tt_) == J.tt_ranks(tj)
    a = T.tt_matrix_to_matrix(tt_).numpy()
    b = np.asarray(J.tt_matrix_to_matrix(tj))
    assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b)


def test_prune_singular_vals():
    cases = [
        (np.array([1.0, 0.5, 1e-9, 1e-10]), 1e-6),
        (np.array([1.0, 0.5, 1e-9, 1e-10]), 1e-12),
        (np.zeros(3), 1e-6),
        (np.array([1e-20]), 1e-6),
        (np.array([2.0, 1.0, 0.0]), 0.0),
        (np.array([3.0, 2.0, 1.0]), 0.0),
    ]
    for s, eps in cases:
        assert TR.prune_singular_vals(s, eps) == JR.prune_singular_vals(s, eps)
        assert TR.prune_singular_vals(torch.as_tensor(s), eps) == JR.prune_singular_vals(s, eps)


def test_rl_orthogonalise():
    Aj, At = both(noisy_low_rank(np.random.RandomState(0), 5, 3, 1e-8))
    Qt = TR.tt_rl_orthogonalise(At)
    check(Qt, JR.tt_rl_orthogonalise(Aj))
    for core in Qt[1:]:
        mat = core.reshape(core.shape[0], -1)
        torch.testing.assert_close(mat @ mat.T, torch.eye(mat.shape[0], dtype=mat.dtype),
                                   atol=1e-12, rtol=0)


@pytest.mark.parametrize("d", [3, 4, 5])
def test_lr_orthogonalise(d):
    """Equal ranks, cores within 1e-12 of the JAX package's up to the signs
    of the bond columns, cores 0..d-2 left-orthogonal, the same matrix."""
    Aj, At = both(noisy_low_rank(np.random.RandomState(d), d, 3, 1e-8))
    Qt, Qj = TR.tt_lr_orthogonalise(At), JR.tt_lr_orthogonalise(Aj)
    check(Qt, Qj)
    sign = torch.ones(1, dtype=torch.float64)
    for k, (ct, cj) in enumerate(zip(Qt, Qj)):
        ct = sign.reshape(-1, *([1] * (ct.dim() - 1))) * ct
        cj = torch.as_tensor(np.asarray(cj))
        if k < d - 1:
            mat = ct.reshape(-1, ct.shape[-1])
            torch.testing.assert_close(mat.T @ mat, torch.eye(mat.shape[1], dtype=mat.dtype),
                                       atol=1e-12, rtol=0)
            flat_t, flat_j = mat, cj.reshape(-1, cj.shape[-1])
            idx = flat_j.abs().argmax(dim=0)
            cols = torch.arange(flat_j.shape[1])
            sign = torch.sign(flat_j[idx, cols]) * torch.sign(flat_t[idx, cols])
            ct = ct * sign
        torch.testing.assert_close(ct, cj, atol=1e-12, rtol=0)


@pytest.mark.parametrize("eps", [1e-15, 1e-6, 1e-3])
def test_rank_reduce(bucket, eps):
    Aj, At = both(noisy_low_rank(np.random.RandomState(1), 5, 3, 1e-9))
    Rt = TR.tt_rank_reduce(At, eps)
    check(Rt, JR.tt_rank_reduce(Aj, eps))
    if bucket == 4:
        assert all(r <= 2 or r % 4 == 0 for r in T.tt_ranks(Rt))


@pytest.mark.parametrize("eps", [1e-8, 1e-3])
def test_psd_rank_reduce(bucket, eps):
    rng = np.random.RandomState(2)
    d = 4
    B = rng.randn(2**d, 2**d)
    P = B.T @ B + 1e-8 * np.eye(2**d)
    Pj = J.tt_matrix_svd(P)
    Pt = tt_to_torch([np.asarray(c) for c in Pj], device="cpu")
    Rj, shift_j = JR.tt_psd_rank_reduce(Pj, eps, return_shift=True)
    Rt, shift_t = TR.tt_psd_rank_reduce(Pt, eps, return_shift=True)
    check(Rt, Rj)
    assert shift_t == pytest.approx(shift_j, rel=1e-8, abs=1e-300)
    eigs = np.linalg.eigvalsh(T.tt_matrix_to_matrix(Rt).numpy())
    assert eigs.min() >= -1e-8


def test_add_kick_rank_same_draws():
    rng = np.random.RandomState(4)
    u = np.linalg.qr(rng.randn(12, 3))[0]
    v = rng.randn(3, 7)
    qj, vj, rj = JR.add_kick_rank(jnp.asarray(u), jnp.asarray(v), 2,
                                  rng=np.random.RandomState(9))
    qt, vt, rt = TR.add_kick_rank(torch.as_tensor(u), torch.as_tensor(v), 2,
                                  rng=np.random.RandomState(9))
    assert rt == rj == 5
    np.testing.assert_allclose((qt @ vt).numpy(), u @ v, atol=1e-12)
    # the same kick directions: the spans agree
    pj = np.asarray(qj) @ np.asarray(qj).T
    np.testing.assert_allclose((qt @ qt.T).numpy(), pj, atol=1e-12)


def test_pad_bond_factors(bucket):
    rng = np.random.RandomState(5)
    left = np.linalg.qr(rng.randn(12, 3))[0].reshape(3, 4, 3)
    right = rng.randn(3, 8)
    lj, rj, kj = JR.pad_bond_factors(jnp.asarray(left), jnp.asarray(right), 3)
    lt, rt, kt = TR.pad_bond_factors(torch.as_tensor(left), torch.as_tensor(right), 3)
    assert kt == kj == (4 if bucket == 4 else 3)
    assert tuple(lt.shape) == tuple(lj.shape)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-12)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-12)
