"""Parity of the PyTorch port's TT algebra with the JAX package.

The same numpy cores (made from a seeded RandomState) go through
``ttipm_tpu.ops.tt`` and ``ttipm_tpu_torch.ops.tt`` (port on the CPU).
Dense values must agree to 1e-10 relative, TT ranks exactly; raw cores are
not compared (SVD column signs may differ between backends).  Rank bucket
1 is pinned in both packages (conftest pins it for the JAX package).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ttipm_tpu.ops.tt as J
import ttipm_tpu_torch.ops.tt as T
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.interop import tt_to_torch

TOL = 1e-10


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def np_train(rng, d, rank, phys):
    ranks = [1] + [rank] * (d - 1) + [1]
    return [rng.standard_normal((ranks[k],) + tuple(phys) + (ranks[k + 1],))
            for k in range(d)]


def both(cores):
    return [jnp.asarray(c) for c in cores], tt_to_torch(cores, device="cpu")


def close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.linalg.norm(b), 1e-300)
    assert np.linalg.norm(a - b) <= tol * scale, np.linalg.norm(a - b) / scale


def dense_pair(tj, tt_):
    return np.asarray(J.tt_matrix_to_matrix(tj)), T.tt_matrix_to_matrix(tt_).numpy()


def check(tt_, tj, tol=TOL):
    """Same TT ranks and the same dense values (matrix or vector train)."""
    assert T.tt_ranks(tt_) == J.tt_ranks(tj)
    if tj[0].ndim == 3:
        close(T.tt_vec_to_vec(tt_).numpy(), np.asarray(J.tt_vec_to_vec(tj)), tol)
    else:
        close(T.tt_matrix_to_matrix(tt_).numpy(), np.asarray(J.tt_matrix_to_matrix(tj)), tol)


@pytest.mark.parametrize("d", [1, 3, 4])
def test_constructors(d):
    for fj, ft in ((J.tt_identity, T.tt_identity), (J.tt_zero_matrix, T.tt_zero_matrix),
                   (J.tt_one_matrix, T.tt_one_matrix)):
        a, b = dense_pair(fj(d), ft(d, device="cpu"))
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("d,r1,r2", [(2, 2, 3), (4, 3, 2)])
def test_add_sub_scale_transpose(d, r1, r2):
    rng = np.random.RandomState(d)
    Aj, At = both(np_train(rng, d, r1, (2, 2)))
    Bj, Bt = both(np_train(rng, d, r2, (2, 2)))
    for fj, ft in (
        (lambda: J.tt_add(Aj, Bj), lambda: T.tt_add(At, Bt)),
        (lambda: J.tt_sub(Aj, Bj), lambda: T.tt_sub(At, Bt)),
        (lambda: J.tt_scale(-2.5, Aj), lambda: T.tt_scale(-2.5, At)),
        (lambda: J.tt_transpose(Aj), lambda: T.tt_transpose(At)),
    ):
        check(ft(), fj())
    with pytest.raises(ValueError):
        T.tt_add(At, Bt[:-1])


def test_inner_norm_trace_sum():
    rng = np.random.RandomState(7)
    Aj, At = both(np_train(rng, 4, 3, (2, 2)))
    Bj, Bt = both(np_train(rng, 4, 2, (2, 2)))
    pairs = [
        (J.tt_inner_prod(Aj, Bj), T.tt_inner_prod(At, Bt)),
        (J.tt_norm(Aj), T.tt_norm(At)),
        (J.tt_trace(Aj), T.tt_trace(At)),
        (J.tt_entrywise_sum(Aj), T.tt_entrywise_sum(At)),
        (J.tt_norm(J.tt_normalise(Aj, 3.0)), T.tt_norm(T.tt_normalise(At, 3.0))),
    ]
    for a, b in pairs:
        assert b == pytest.approx(a, rel=TOL, abs=1e-12)


def test_diag_diagonal_diag_op():
    rng = np.random.RandomState(3)
    vj, vt = both(np_train(rng, 3, 2, (2,)))
    Dj, Dt = J.tt_diag(vj), T.tt_diag(vt)
    check(Dt, Dj)
    check(T.tt_diagonal(Dt), J.tt_diagonal(Dj))
    Mj, Mt = both(np_train(rng, 3, 2, (2, 2)))
    check(T.tt_diag_op(Mt), J.tt_diag_op(Mj))


def test_reshape_merge_split():
    rng = np.random.RandomState(4)
    Aj, At = both(np_train(rng, 4, 3, (2, 2)))
    vj, vt = J.tt_reshape(Aj, (4,)), T.tt_reshape(At, (4,))
    check(vt, vj)
    check(T.tt_reshape(vt, (2, 2)), J.tt_reshape(vj, (2, 2)))
    # merging pairs of vector cores (physical 4 -> 16)
    mj, mt = J.tt_reshape(vj, (16,)), T.tt_reshape(vt, (16,))
    assert len(mt) == len(mj) == 2
    check(mt, mj)
    sj, st = J.tt_split_bonds(Aj), T.tt_split_bonds(At)
    assert [tuple(c.shape) for c in st] == [tuple(c.shape) for c in sj]
    check(T.tt_merge_bonds(st), J.tt_merge_bonds(sj))


def test_kron_lifts():
    rng = np.random.RandomState(5)
    Mj, Mt = both(np_train(rng, 3, 2, (2, 2)))
    for fj, ft in ((J.tt_IkronM, T.tt_IkronM), (J.tt_MkronI, T.tt_MkronI)):
        oj, ot = fj(Mj), ft(Mt)
        assert [tuple(c.shape) for c in ot] == [tuple(c.shape) for c in oj]
        check(ot, oj)


@pytest.mark.parametrize("d", [2, 3])
def test_matrix_svd_roundtrip(d):
    A = np.random.RandomState(d).randn(2**d, 2**d)
    Tj, Tt = J.tt_matrix_svd(A), T.tt_matrix_svd(torch.as_tensor(A))
    assert T.tt_ranks(Tt) == J.tt_ranks(Tj)
    close(T.tt_matrix_to_matrix(Tt).numpy(), A, tol=1e-12)


def test_symmetric_powers_of_two():
    for n in (0, 1, 4, 5, 8):
        np.testing.assert_array_equal(T.symmetric_powers_of_two(n),
                                      J.symmetric_powers_of_two(n))


@pytest.mark.parametrize("d,r,seed", [(3, 1, 2), (4, 2, 9)])
def test_random_graph_same_draws(d, r, seed):
    from ttipm_tpu.ops.random import tt_random_graph as graph_j
    from ttipm_tpu_torch.ops.random import tt_random_graph as graph_t

    np.random.seed(seed)
    Gj = graph_j(d, r)
    state = np.random.get_state()
    np.random.seed(seed)
    Gt = graph_t(d, r, device="cpu")
    # both consumed the same numpy stream
    assert np.random.get_state()[2] == state[2]
    np.testing.assert_array_equal(np.random.get_state()[1], state[1])
    check(Gt, Gj)


@pytest.mark.parametrize("dim,seed", [(2, 11), (3, 319), (4, 5)])
def test_create_problem_same_instance(dim, seed):
    from ttipm_tpu.models.maxcut import create_problem as cp_j
    from ttipm_tpu_torch.models.maxcut import create_problem as cp_t

    np.random.seed(seed)
    out_j = cp_j(dim, 1)
    np.random.seed(seed)
    out_t = cp_t(dim, 1, device="cpu")
    # explicit RandomState gives the same instance as the global stream
    out_r = cp_t(dim, 1, device="cpu", rng=np.random.RandomState(seed))
    for tj, tt_, tr in zip(out_j, out_t, out_r):
        check(tt_, tj)
        assert T.tt_ranks(tr) == T.tt_ranks(tt_)
        for a, b in zip(tr, tt_):
            assert torch.equal(a, b)
