"""Parity of the port's ragged solvers with the JAX package: LGMRES, the
block local products, the ragged AMEn, the IPM's local KKT solver and the
ragged step-size eigensolver, each run from the same numpy seeds through
both packages on the CPU.

Tolerances: LGMRES solutions 1e-10 relative; block local products 1e-12
relative; AMEn solutions (dense) 1e-8 relative with equal final ranks; the
local KKT solver's outputs 1e-10 of ||rhs||; step sizes 1e-8 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttipm_tpu.ops import tt as J
from ttipm_tpu.ops.products import tt_mat_mat_exact, tt_mat_vec_exact
from ttipm_tpu.ops.random import tt_random_gaussian
from ttipm_tpu.ops.rounding import (
    add_kick_rank_rev as kick_rev_j,
    tt_rank_reduce,
    tt_rank_retraction as retract_j,
    truncated_svd as tsvd_j,
)
from ttipm_tpu.solvers import amen as JA
from ttipm_tpu.solvers import blocks as JB
from ttipm_tpu.solvers import eigen as JE
from ttipm_tpu.solvers import lgmres as JL
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.interop import tt_to_torch
from ttipm_tpu_torch.ops import tt as T
from ttipm_tpu_torch.ops.rounding import (
    add_kick_rank_rev as kick_rev_t,
    tt_rank_retraction as retract_t,
    truncated_svd as tsvd_t,
)
from ttipm_tpu_torch.solvers import amen as TA
from ttipm_tpu_torch.solvers import blocks as TB
from ttipm_tpu_torch.solvers import eigen as TE
from ttipm_tpu_torch.solvers import lgmres as TL
from ttipm_tpu_torch.solvers import local_kkt as TK


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def tt_t(train):
    return tt_to_torch([np.asarray(c) for c in train], device="cpu")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def block_matrix_t(mat):
    out = TB.TTBlockMatrix()
    for key, train in mat._data.items():
        out[key] = tt_t(train)
    out._aliases = dict(mat._aliases)
    out._transposes = dict(mat._transposes)
    return out


def block_vector_t(vec):
    out = TB.TTBlockVector()
    for i, train in vec.items():
        out[i] = tt_t(train)
    return out


# --- LGMRES ------------------------------------------------------------------

def _ill_system(n=150, seed=7):
    rng = np.random.RandomState(seed)
    evals = np.r_[np.logspace(-4, -2, 10), np.ones(n - 10) + 0.01 * rng.randn(n - 10)]
    q, _ = np.linalg.qr(rng.randn(n, n))
    return (q * evals) @ q.T, rng.randn(n)


def _easy_system(n=40):
    rng = np.random.RandomState(0)
    return np.eye(n) + 0.1 * rng.randn(n, n), rng.randn(n)


@pytest.mark.parametrize("solver", ["lgmres", "gmres_restarted"])
@pytest.mark.parametrize("system,kw", [
    ("ill", dict(rtol=1e-12, restart=8, maxiter=15)),
    ("easy", dict(rtol=1e-12, restart=45, maxiter=2)),
])
def test_lgmres_matches_jax(solver, system, kw):
    A, b = _ill_system() if system == "ill" else _easy_system()
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x_j, info_j = getattr(JL, solver)(lambda v: Aj @ v, bj, **kw)
    x_t, info_t = getattr(TL, solver)(lambda v: At @ v, bt, **kw)
    assert info_t == info_j
    assert rel(x_t, x_j) < 1e-10


# --- rounding helpers of the sweeps --------------------------------------------

def test_retraction_and_kicks_match_jax():
    np.random.seed(3)
    x = tt_random_gaussian([3, 4, 3], (2,))
    out_j, out_t = retract_j(list(x), [2, 2, 2]), retract_t(tt_t(x), [2, 2, 2])
    assert [c.shape for c in out_t] == [tuple(c.shape) for c in out_j]
    assert rel(T.tt_vec_to_vec(out_t), J.tt_vec_to_vec(out_j)) < 1e-12
    m = np.random.randn(9, 7)
    u_j, v_j = tsvd_j(jnp.asarray(m), 3)
    u_t, v_t = tsvd_t(torch.from_numpy(m), 3)
    assert rel(u_t @ v_t, np.asarray(u_j @ v_j)) < 1e-12
    u, v = np.random.randn(6, 3), np.random.randn(3, 8)
    np.random.seed(5)
    a_j, q_j, r_j = kick_rev_j(jnp.asarray(u), jnp.asarray(v), 2)
    np.random.seed(5)
    a_t, q_t, r_t = kick_rev_t(torch.from_numpy(u), torch.from_numpy(v), 2)
    assert r_t == r_j == 5
    assert rel(a_t @ q_t, np.asarray(a_j @ q_j)) < 1e-12
    assert rel(q_t @ q_t.T, np.eye(5)) < 1e-12


# --- block local products (K2's plain version on the CPU) ---------------------

def test_block_local_products_match_jax():
    """Every local product of the sweeps, on random interfaces of a KKT-like
    block matrix with a transpose and an alias."""
    rng = np.random.RandomState(11)
    k = 1
    blocks = {(0, 0): [2, 2], (0, 1): [3, 2], (1, 2): [1, 1], (2, 1): [2, 3], (2, 2): [2, 2]}
    mat = JB.TTBlockMatrix()
    for key, ranks in blocks.items():
        mat[key] = tt_random_gaussian(ranks, (4, 4))
    mat.add_alias((0, 1), (1, 0), is_transpose=True)
    mat.add_alias((1, 2), (1, 3))
    mat_t = block_matrix_t(mat)
    vj, vt = mat[k], mat_t[k]
    rx, rx1, rz, rz1 = 3, 4, 2, 3
    keys = list(blocks) + [(1, 0)]

    def rank(key, side):
        train = blocks[(0, 1) if key == (1, 0) else key]
        return ([1] + train + [1])[k + side]

    def phis(l, r, side):
        return {key: rng.randn(l, rank(key, side), r) for key in keys}

    XL, XR, ZL, ZR = phis(rx, rx, 0), phis(rx1, rx1, 1), phis(rz, rx, 0), phis(rz1, rx1, 1)
    cases = [
        ("block_local_product", (XL, XR), rng.randn(rx, 4, 4, rx1), None),
        ("compressed_block_local_product", (ZL, ZR), rng.randn(rx, 4, 4, rx1), (rz, 4, 4, rz1)),
        ("lcompressed_block_local_product", (ZL, XR), rng.randn(rx, 4, 4, rx1), (rz, 4, 4, rx1)),
        ("rcompressed_block_local_product", (XL, ZR), rng.randn(rx, 4, 4, rx1), (rx, 4, 4, rz1)),
    ]
    for name, (pl, pr), x, shape in cases:
        pl_j = {key: jnp.asarray(v) for key, v in pl.items()}
        pr_j = {key: jnp.asarray(v) for key, v in pr.items()}
        pl_t = {key: torch.from_numpy(v) for key, v in pl.items()}
        pr_t = {key: torch.from_numpy(v) for key, v in pr.items()}
        extra = () if shape is None else (shape,)
        y_j = getattr(vj, name)(pl_j, pr_j, jnp.asarray(x), *extra)
        y_t = getattr(vt, name)(pl_t, pr_t, torch.from_numpy(x), *extra)
        assert tuple(y_t.shape) == tuple(y_j.shape), name
        assert rel(y_t, y_j) < 1e-12, name
    xq = rng.randn(3, rx, 4, 4, rx1)
    y_j = vj.block_local_product_batched(
        {q: jnp.asarray(v) for q, v in XL.items()}, {q: jnp.asarray(v) for q, v in XR.items()},
        jnp.asarray(xq))
    y_t = vt.block_local_product_batched(
        {q: torch.from_numpy(v) for q, v in XL.items()},
        {q: torch.from_numpy(v) for q, v in XR.items()}, torch.from_numpy(xq))
    assert rel(y_t, y_j) < 1e-12


# --- ragged AMEn on the cases of tests/test_amen.py ---------------------------

def spd_operator_tt(dim, rank, shift=2.0):
    A = tt_random_gaussian([rank] * (dim - 1), (2, 2))
    return tt_rank_reduce(J.tt_add(tt_mat_mat_exact(J.tt_transpose(A), A),
                                   J.tt_scale(shift, J.tt_identity(dim))), 1e-12)


def _single_block(dim, shift=2.0):
    A = spd_operator_tt(dim, 2, shift)
    x_true = tt_random_gaussian([2] * (dim - 1), (2,))
    mat, vec = JB.TTBlockMatrix(), JB.TTBlockVector()
    mat[0, 0] = A
    vec[0] = tt_mat_vec_exact(A, x_true)
    return mat, vec


def _two_block():
    dim = 3
    A = spd_operator_tt(dim, 2, shift=3.0)
    A2 = spd_operator_tt(dim, 2, shift=3.0)
    B = tt_rank_reduce(J.tt_scale(0.2, tt_random_gaussian([2] * (dim - 1), (2, 2))), 1e-12)
    x0 = tt_random_gaussian([2] * (dim - 1), (2,))
    x1 = tt_random_gaussian([2] * (dim - 1), (2,))
    mat, vec = JB.TTBlockMatrix(), JB.TTBlockVector()
    mat[0, 0], mat[0, 1], mat[1, 1] = A, B, A2
    mat.add_alias((0, 1), (1, 0), is_transpose=True)
    vec[0] = tt_rank_reduce(J.tt_add(tt_mat_vec_exact(A, x0), tt_mat_vec_exact(B, x1)), 1e-12)
    vec[1] = tt_rank_reduce(J.tt_add(tt_mat_vec_exact(J.tt_transpose(B), x0),
                                     tt_mat_vec_exact(A2, x1)), 1e-12)
    return mat, vec


def _dense_blocks(x_sol, nblocks, tt_get_block, vec_to_vec):
    return np.concatenate([np.asarray(vec_to_vec(tt_get_block(i, list(x_sol)))).ravel()
                           for i in range(nblocks)])


AMEN_CASES = {
    "single_block": (lambda: _single_block(4), "tt_block_amen",
                     dict(term_tol=1e-8, nswp=10, amen=True)),
    "two_block_transpose": (_two_block, "tt_block_amen",
                            dict(term_tol=1e-8, nswp=12, amen=True)),
    "restarted": (lambda: _single_block(3), "tt_restarted_block_amen",
                  dict(rank_restriction=10, op_tol=1e-8, termination_tol=1e-7, inner_m=10)),
    "restarted_refined": (lambda: _single_block(3), "tt_restarted_block_amen",
                          dict(rank_restriction=10, op_tol=1e-8, termination_tol=1e-2,
                               inner_m=4, refine="1e-10")),
}


@pytest.mark.parametrize("case", sorted(AMEN_CASES))
def test_ragged_amen_matches_jax(case):
    make, fn, kw = AMEN_CASES[case]
    np.random.seed(4)
    mat, vec = make()
    kw = dict(kw)
    if kw.pop("refine", None):
        kw["refine_target"] = 1e-10 * vec.norm
    nblocks = len(vec.keys())
    np.random.seed(21)
    x_j, res_j = getattr(JA, fn)(mat, vec, **kw)
    np.random.seed(21)
    x_t, res_t = getattr(TA, fn)(block_matrix_t(mat), block_vector_t(vec), **kw)
    assert [c.shape for c in x_t] == [tuple(c.shape) for c in x_j]
    xd_j = _dense_blocks(x_j, nblocks, JB.tt_get_block, J.tt_vec_to_vec)
    xd_t = _dense_blocks(x_t, nblocks, TB.tt_get_block, T.tt_vec_to_vec)
    assert rel(xd_t, xd_j) < 1e-8
    assert res_t == pytest.approx(res_j, rel=1e-6, abs=1e-12)


# --- the IPM's local KKT solver on the first ragged local system of the
# forced-exhaustion d3 solve (tests/test_fallback.py) -------------------------

class _Captured(BaseException):
    """Stops the JAX solve at its first ragged local solve (a BaseException,
    so the Newton step's recovery does not absorb it)."""


@pytest.fixture(scope="module")
def first_local_system():
    import ttipm_tpu.ipm as jipm
    import ttipm_tpu.solvers.fused as jfused
    from ttipm_tpu import config as jconfig
    from ttipm_tpu.models.maxcut import create_problem

    captured = {}

    def exhausted(*a, **k):
        raise JA.AmenRestartsExhausted("synthetic exhaustion")

    def capture(*args):
        captured["args"] = args
        raise _Captured()

    saved = (jfused.tt_restarted_block_amen_fused, jipm.ipm_local_solver,
             jconfig.fused_kkt(), jconfig.rank_bucket())
    jfused.tt_restarted_block_amen_fused = exhausted
    jipm.ipm_local_solver = capture
    jconfig.set_fused_kkt(True)
    jconfig.set_rank_bucket(1)
    try:
        np.random.seed(5)
        obj, L, b, lag = create_problem(3, 1)
        with pytest.raises(_Captured):
            jipm.tt_ipm({"y": J.tt_reshape(lag, (4, 4))}, obj, L, b, max_iter=8,
                        gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                        aho_direction=False, mals_restarts=2, max_refinement=3)
    finally:
        jfused.tt_restarted_block_amen_fused, jipm.ipm_local_solver = saved[:2]
        jconfig.set_fused_kkt(saved[2])
        jconfig.set_rank_bucket(saved[3])
    return captured["args"]


def _port_args(args):
    XAX_k, A_k, XAX_k1, Xb_k, b_k, Xb_k1, prev, size_limit, _ = args
    mat = TB.TTBlockMatrix()
    for key, train in A_k._data.items():
        mat[key] = tt_t(train)
    mat._aliases, mat._transposes = dict(A_k._aliases), dict(A_k._transposes)
    vec = TB.TTBlockVector()
    for i, train in b_k._data.items():
        vec[i] = tt_t(train)

    def phis(p):
        return {key: torch.from_numpy(np.array(v)) for key, v in p.items()}

    return (phis(XAX_k), mat[A_k._idx], phis(XAX_k1), phis(Xb_k), vec[b_k._idx], phis(Xb_k1),
            torch.from_numpy(np.array(prev)), size_limit)


@pytest.mark.parametrize("dense", [True, False])
def test_local_solver_matches_jax(first_local_system, dense):
    from ttipm_tpu.solvers.local_kkt import ipm_local_solver as local_j

    args = first_local_system
    out_j = local_j(*args[:8], dense)
    out_t = TK.ipm_local_solver(*_port_args(args), dense)
    sol_j, old_j, new_j, rhs_j, nrm_j, fail_j = out_j
    sol_t, old_t, new_t, rhs_t, nrm_t, fail_t = out_t
    assert fail_t == fail_j == (not dense)
    scale = float(np.linalg.norm(np.asarray(rhs_j)))
    assert float(torch.linalg.norm(rhs_t - torch.from_numpy(np.array(rhs_j)))) <= 1e-10 * scale
    assert float(torch.linalg.norm(sol_t - torch.from_numpy(np.array(sol_j)))) <= 1e-10 * scale
    assert nrm_t == pytest.approx(nrm_j, rel=1e-10)
    assert abs(old_t - old_j) <= 1e-10 and abs(new_t - new_j) <= 1e-10


# --- ragged step-size eigensolver ---------------------------------------------

def _psd_tt(dim, rank, shift):
    A = tt_random_gaussian([rank] * (dim - 1), (2, 2))
    return tt_rank_reduce(J.tt_add(tt_mat_mat_exact(J.tt_transpose(A), A),
                                   J.tt_scale(shift, J.tt_identity(dim))), 1e-12)


def _sym_tt(dim, rank):
    A = tt_random_gaussian([rank] * (dim - 1), (2, 2))
    return tt_rank_reduce(J.tt_scale(0.5, J.tt_add(A, J.tt_transpose(A))), 1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_generalised_eigen_matches_jax(seed):
    """The case of tests/test_eigen.py:64 (dim 4), three seeds; the step is
    also safe against the dense oracle."""
    np.random.seed(seed)
    A, D = _psd_tt(4, 2, 1.0), _sym_tt(4, 2)
    np.random.seed(100 + seed)
    alpha_j, x_j = JE.tt_max_generalised_eigen(A, D, tol=1e-8)
    np.random.seed(100 + seed)
    alpha_t, x_t = TE.tt_max_generalised_eigen(tt_t(A), tt_t(D), tol=1e-8)
    assert alpha_t == pytest.approx(alpha_j, rel=1e-8)
    assert T.tt_ranks(x_t) == J.tt_ranks(x_j)
    Ad = np.asarray(J.tt_matrix_to_matrix(A))
    Dd = np.asarray(J.tt_matrix_to_matrix(D))
    assert np.linalg.eigvalsh(0.5 * (Ad + Ad.T) + alpha_t * 0.5 * (Dd + Dd.T)).min() >= -1e-6


@pytest.mark.parametrize("dim,seed", [(5, 0), (6, 1)])
def test_max_generalised_eigen_matches_jax_above_d4(dim, seed):
    """tests/test_eigen.py:64's case at d5 and d6, Delta scaled by 8 so that
    the step lies below its cap of 1: the step within 1e-8 of the JAX
    package's, equal ranks, and safe against the dense oracle at the JAX
    test's bound (-1e-6).  No case of this solver reaches the LOBPCG
    deviation at d5 or d6: its windows hold 4 r^2 entries with r at most
    floor(2^(d/2)), 256 at d6, the dense gate."""
    np.random.seed(seed)
    A, D = _psd_tt(dim, 2, 1.0), J.tt_scale(8.0, _sym_tt(dim, 2))
    np.random.seed(100 + seed)
    alpha_j, x_j = JE.tt_max_generalised_eigen(A, D, tol=1e-8)
    np.random.seed(100 + seed)
    alpha_t, x_t = TE.tt_max_generalised_eigen(tt_t(A), tt_t(D), tol=1e-8)
    assert alpha_t < 1.0
    assert alpha_t == pytest.approx(alpha_j, rel=1e-8)
    assert T.tt_ranks(x_t) == J.tt_ranks(x_j)
    Ad = np.asarray(J.tt_matrix_to_matrix(A))
    Dd = np.asarray(J.tt_matrix_to_matrix(D))
    assert np.linalg.eigvalsh(0.5 * (Ad + Ad.T) + alpha_t * 0.5 * (Dd + Dd.T)).min() >= -1e-6


@pytest.mark.parametrize("dim,seed", [(5, 0), (6, 1)])
def test_min_eig_matches_jax_above_d4(dim, seed, monkeypatch):
    """tests/test_eigen.py:89's case (the smallest eigenvalue of Diag(M))
    at d5 and d6.  Its windows (physical size 4: 16 r^2 entries) pass the
    dense gate of 256, so these cases run the port's LOBPCG with its own
    random start (the recorded deviation): the eigenvalue within 1e-8 of
    the JAX package's.  At d5 it is M's minimum entry within the JAX
    test's 1e-5; at d6 both packages stop at the same eigenvalue above it
    (seed 1: 2.6e-4 above; seed 0: 0.023), a limit of the reference's
    sweep that the port mirrors."""
    from ttipm_tpu.ops.tt import tt_diag_op

    windows = []
    lobpcg = TE._lobpcg_mixed

    def counted(kind, triples, x0, *a, **kw):
        windows.append(x0.numel())
        return lobpcg(kind, triples, x0, *a, **kw)

    monkeypatch.setattr(TE, "_lobpcg_mixed", counted)
    np.random.seed(seed)
    M = _sym_tt(dim, 2)
    op = tt_diag_op(M, 1e-12)
    np.random.seed(2)
    _, val_j = JE.tt_min_eig(op, tol=1e-9, return_eig_val=True)
    np.random.seed(2)
    _, val = TE.tt_min_eig(tt_t(op), tol=1e-9, return_eig_val=True)
    assert windows and max(windows) > 256
    assert val == pytest.approx(float(val_j), rel=1e-8)
    low = np.asarray(J.tt_matrix_to_matrix(M)).min()
    if dim == 5:
        assert abs(val - low) < 1e-5
    else:
        assert val > low + 1e-4


@pytest.mark.parametrize("generalized", [False, True])
def test_lobpcg_smallest(generalized):
    rng = np.random.RandomState(3)
    n = 40
    Q = np.linalg.qr(rng.randn(n, n))[0]
    A = Q @ np.diag(np.linspace(-1.0, 3.0, n)) @ Q.T
    Bm = rng.randn(n, n)
    B = Bm @ Bm.T + n * np.eye(n)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    lam, x, _ = TE.lobpcg_smallest(lambda v: At @ v, torch.from_numpy(rng.randn(n)), tol=1e-9,
                                   maxiter=300,
                                   b_matvec=(lambda v: Bt @ v) if generalized else None)
    import scipy.linalg as sla

    true = sla.eigh(A, B if generalized else None, eigvals_only=True)[0]
    assert abs(lam - true) < 1e-5


def test_lobpcg_window_adversarial_near_diagonal():
    """tests/test_eigen.py:100 through the port: a near-diagonal window of
    size 512 (above the dense gate) and a warm start that is exactly an
    interior eigenvector; the random mixing must still reach the extremal
    eigenvalue."""
    rng = np.random.RandomState(7)
    l = L = nm = 8
    eye = np.zeros((l, 1, l))
    eye[:, 0, :] = np.eye(l)
    diag = np.linspace(1.0, 2.0, nm)
    diag[3] = 0.1
    A_k = np.zeros((1, nm, nm, 1))
    A_k[0, :, :, 0] = np.diag(diag)
    coup = rng.randn(nm, nm) * 1e-9
    A_k[0, :, :, 0] += coup + coup.T
    x0 = np.zeros((l, nm, L))
    x0[0, 5, 0] = 1.0
    ops = tuple(torch.from_numpy(a) for a in (eye, A_k, eye))
    lam, _, _ = TE.lobpcg_window("w1", ops, torch.from_numpy(x0), tol=1e-8, maxiter=600)
    assert abs(lam - 0.1) < 1e-4
