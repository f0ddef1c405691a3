"""Parity of the port's TT products with the JAX package (exact, "fast",
ALS-fitted and rank-dispatched forms), at rank bucket 1 and 4.

Operands are numpy cores from a seeded RandomState fed to both packages;
the ALS fits draw their random starts and kicks from numpy RandomStates
seeded alike.  Dense values must agree to 1e-10 relative and TT ranks
exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import ttipm_tpu.ops.products as JP
import ttipm_tpu.ops.tt as J
import ttipm_tpu_torch.ops.products as TP
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


def train(rng, d, rank, phys):
    ranks = [1] + [rank] * (d - 1) + [1]
    cores = [rng.standard_normal((ranks[k],) + phys + (ranks[k + 1],)) for k in range(d)]
    return [jnp.asarray(c) for c in cores], tt_to_torch(cores, device="cpu")


def check(tt_, tj, tol=TOL):
    assert T.tt_ranks(tt_) == J.tt_ranks(tj)
    if tj[0].ndim == 3:
        a, b = T.tt_vec_to_vec(tt_).numpy(), np.asarray(J.tt_vec_to_vec(tj))
    else:
        a, b = T.tt_matrix_to_matrix(tt_).numpy(), np.asarray(J.tt_matrix_to_matrix(tj))
    assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), np.linalg.norm(a - b) / np.linalg.norm(b)


def test_exact_products():
    rng = np.random.RandomState(0)
    Aj, At = train(rng, 4, 3, (2, 2))
    Bj, Bt = train(rng, 4, 2, (2, 2))
    xj, xt = train(rng, 4, 2, (2,))
    yj, yt = train(rng, 4, 3, (2,))
    check(TP.tt_mat_vec_exact(At, xt), JP.tt_mat_vec_exact(Aj, xj))
    check(TP.tt_mat_mat_exact(At, Bt), JP.tt_mat_mat_exact(Aj, Bj))
    check(TP.tt_hadamard_exact(At, Bt), JP.tt_hadamard_exact(Aj, Bj))
    check(TP.tt_hadamard_exact(xt, yt), JP.tt_hadamard_exact(xj, yj))


def test_fast_products(bucket):
    rng = np.random.RandomState(1)
    Aj, At = train(rng, 4, 3, (2, 2))
    Bj, Bt = train(rng, 4, 3, (2, 2))
    xj, xt = train(rng, 4, 2, (2,))
    check(TP.tt_fast_matrix_vec_mul(At, xt, 1e-10), JP.tt_fast_matrix_vec_mul(Aj, xj, 1e-10))
    check(TP.tt_fast_mat_mat_mul(At, Bt, 1e-10), JP.tt_fast_mat_mat_mul(Aj, Bj, 1e-10))
    check(TP.tt_fast_hadamard(At, Bt, 1e-10), JP.tt_fast_hadamard(Aj, Bj, 1e-10))


def test_als_products_same_draws(bucket):
    rng = np.random.RandomState(2)
    Aj, At = train(rng, 4, 3, (2, 2))
    Bj, Bt = train(rng, 4, 3, (2, 2))
    xj, xt = train(rng, 4, 3, (2,))
    np.random.seed(21)
    outj = JP.tt_approx_mat_mat_mul(Aj, Bj, tol=1e-8, nswp=30)
    outt = TP.tt_approx_mat_mat_mul(At, Bt, tol=1e-8, nswp=30, rng=np.random.RandomState(21))
    check(outt, outj, tol=1e-9)
    np.random.seed(22)
    outj = JP.tt_approx_mat_vec_mul(Aj, xj, tol=1e-8, nswp=30)
    np.random.seed(22)
    outt = TP.tt_approx_mat_vec_mul(At, xt, tol=1e-8, nswp=30)
    check(outt, outj, tol=1e-9)


def test_dispatchers(bucket):
    rng = np.random.RandomState(3)
    Aj, At = train(rng, 4, 2, (2, 2))
    Bj, Bt = train(rng, 4, 2, (2, 2))
    xj, xt = train(rng, 4, 2, (2,))
    check(TP.tt_mat_mat_mul(At, Bt, 1e-8, 1e-10), JP.tt_mat_mat_mul(Aj, Bj, 1e-8, 1e-10))
    check(TP.tt_mat_vec_mul(At, xt, 1e-8, 1e-10), JP.tt_mat_vec_mul(Aj, xj, 1e-8, 1e-10))
    # rank products above 40 / 80 take the ALS route in both packages
    A9j, A9t = train(rng, 4, 9, (2, 2))
    B9j, B9t = train(rng, 4, 9, (2, 2))
    x9j, x9t = train(rng, 4, 10, (2,))
    np.random.seed(31)
    outj = JP.tt_mat_mat_mul(A9j, B9j, 1e-7, 1e-10)
    np.random.seed(31)
    outt = TP.tt_mat_mat_mul(A9t, B9t, 1e-7, 1e-10)
    check(outt, outj, tol=1e-8)
    np.random.seed(32)
    outj = JP.tt_mat_vec_mul(A9j, x9j, 1e-7, 1e-10)
    np.random.seed(32)
    outt = TP.tt_mat_vec_mul(A9t, x9t, 1e-7, 1e-10)
    check(outt, outj, tol=1e-8)

