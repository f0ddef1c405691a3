"""Parity of the port's inequality path with the JAX package, on the CPU at
rank bucket 1, from the same numpy inputs.

* ``E``, ``tt_mask_rank_reduce`` (the case of tests/test_rounding.py:92)
  and the corr_clust / max_stable_set generators at d3: the same trains
  (equal ranks, values to 1e-12 relative).
* The fused algebra with inequalities: the three block products (nine
  terms on four rows, each one K2 call) and ``project_rhs`` against the
  JAX package's ``make_algebra(np.einsum, np, ...)`` at 1e-12 relative;
  ``_dense_factor`` / ``_dense_apply`` and the guarded local solve against
  the JAX host engine (one K1 group of six blocks) at 1e-9 relative;
  ``tt_block_amen_fused(ineq=True)`` on ``_make_ineq_kkt_system``
  (tests/test_fused.py:390) to a relative residual < 1e-5.
* ``tt_min_eig_fused`` against dense ``eigvalsh`` (tests/test_fused.py:222)
  and the ragged ``tt_min_eig`` against the minimum entry
  (tests/test_eigen.py:89), both also against the JAX package's
  eigenvalue (1e-8 relative).
* The fused inequality ladder on the JAX package's first Newton system of
  corr_clust d3 seed 291, both ladders from the same numpy state: the same
  local solves (res_old to 1e-8 relative, 1e-13 absolute at the floor),
  final residuals at the floor (< 1e-9) and solution (1e-8 relative).
* ``ipm_local_solver_ineq`` on the first ragged local system of a
  forced-exhaustion corr_clust d3 solve, dense and LGMRES branches: the
  JAX package's outputs to 1e-10 of ||rhs||.
* End to end: corr_clust d3 seed 291 (tests/test_ipm_e2e.py:172), the
  fully ragged corr_clust d2 seed 11, max_stable_set d3 seed 3 (:83) and
  max_stable_set d4 seed 384 under configs/max_stable_set_6.yaml's settings:
  the same iterations, final ``ineq_status`` and X / Z / T ranks as the JAX
  package, <C, X> to 1e-6 relative,
  slackness and feasibility < 1e-3, and the mask conditions of
  tests/test_ipm_e2e.py:196-204.  The corr_clust solve runs at least one
  nine-term K2 product and one six-block K1 group.

Run as a script on the CPU, with the settings of configs/CONFIG.yaml at
dimension DIM:

* ``python -m tests.test_torch_ineq PROBLEM CONFIG DIM SEEDS`` (SEEDS
  comma-separated) solves each seed in both packages and prints
  iterations, slackness, ranks and <C, X> of each;
* ``python -m tests.test_torch_ineq replay PROBLEM CONFIG DIM SEED CALL``
  replays the JAX package's CALL-th fused ladder solve of that seed through
  both ladders, and through the port's with numpy's SVD in its split steps,
  and prints their sweep residuals.
"""

import itertools
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from ttipm_tpu import config as jconfig
from ttipm_tpu.ipm import tt_ipm as ipm_j
from ttipm_tpu.models import corr_clust as JCC
from ttipm_tpu.models import max_stable_set as JMSS
from ttipm_tpu.ops import tt as J
from ttipm_tpu.ops.products import tt_hadamard_exact
from ttipm_tpu.ops.random import tt_random_gaussian, tt_random_graph
from ttipm_tpu.ops.rounding import tt_mask_rank_reduce as mask_rr_j
from ttipm_tpu.ops.rounding import tt_rank_reduce
from ttipm_tpu.solvers import amen as JA
from ttipm_tpu.solvers import fused_host as JH
from ttipm_tpu.solvers.fused_algebra import make_algebra
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.checks import solve_metrics
from ttipm_tpu_torch.interop import (
    block_matrix_to_torch,
    block_vector_to_torch,
    tt_to_numpy,
    tt_to_torch,
)
from ttipm_tpu_torch.ipm import IneqStatus, tt_ipm as ipm_t
from ttipm_tpu_torch.models import corr_clust as TCC
from ttipm_tpu_torch.models import max_stable_set as TMSS
from ttipm_tpu_torch.ops import kernels as K
from ttipm_tpu_torch.ops import tt as T
from ttipm_tpu_torch.ops.rounding import tt_mask_rank_reduce as mask_rr_t
from ttipm_tpu_torch.solvers import fused_batch as fb
from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1
from ttipm_tpu_torch.solvers import fused as TF
from ttipm_tpu_torch.solvers import fused_algebra as fa
from ttipm_tpu_torch.solvers import local_kkt as TK
from ttipm_tpu_torch.solvers.eigen import tt_min_eig as min_eig_t
from ttipm_tpu_torch.solvers.fused_eigen import tt_min_eig_fused as min_eig_fused_t
from tests.test_eigen import sym_tt
from tests.test_fused import _make_ineq_kkt_system
from tests.test_torch_ragged import _Captured, _port_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)
CC_SETTINGS = dict(SETTINGS, lambdaStarIneq=1e-3)


@pytest.fixture(autouse=True)
def _settings():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)
    tconfig.set_fused_kkt(True)
    jconfig.set_fused_kkt(True)


def tt_t(train):
    return tt_to_torch([np.asarray(c) for c in train], device="cpu")


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def full(train):
    """The tensor a train represents (cores contracted in order)."""
    out = np.asarray(train[0])
    for c in train[1:]:
        out = np.tensordot(out, np.asarray(c), axes=([-1], [0]))
    return out


def assert_same_train(t_port, t_jax, tol=1e-12):
    assert [tuple(c.shape) for c in t_port] == [tuple(np.shape(c)) for c in t_jax]
    assert rel(full(tt_to_numpy(t_port)), full(t_jax)) <= tol


class Spy:
    """Records the group sizes of the grouped K1 / K2 entries."""

    def __init__(self, monkeypatch):
        self.k1, self.k2 = Counter(), Counter()
        k1, k2 = K.schur_assemble_group, K.kkt_block_product

        def group(blocks):
            self.k1[len(blocks)] += 1
            return k1(blocks)

        def product(terms, nrows):
            self.k2[(len(terms), nrows)] += 1
            return k2(terms, nrows)

        monkeypatch.setattr(K, "schur_assemble_group", group)
        monkeypatch.setattr(K, "kkt_block_product", product)


# --- TT building blocks and the generators -----------------------------------

def test_elementary_cores():
    for i, j in itertools.product(range(2), range(2)):
        got = T.E(i, j, device="cpu")
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), np.asarray(J.E(i, j)))


def test_mask_rank_reduce_matches_jax():
    """The case of tests/test_rounding.py:92: compensation along the mask,
    off-mask entries stay below the tolerance."""
    dim = 4
    mask = tt_random_graph(dim, 2)
    noise = J.tt_scale(1e-7, tt_random_gaussian([2] * (dim - 1), (2, 2)))
    Tm = J.tt_add(tt_hadamard_exact(mask, tt_random_gaussian([2] * (dim - 1), (2, 2))),
                  tt_hadamard_exact(mask, noise))
    R_j, shift_j = mask_rr_j(Tm, mask, 1e-4, return_shift=True)
    R_t, shift_t = mask_rr_t(tt_t(Tm), tt_t(mask), 1e-4, return_shift=True)
    assert T.tt_ranks(R_t) == J.tt_ranks(R_j)
    assert rel(T.tt_matrix_to_matrix(R_t).numpy(), J.tt_matrix_to_matrix(R_j)) <= 1e-12
    assert shift_t == pytest.approx(shift_j, rel=1e-10, abs=1e-300)
    Rd = T.tt_matrix_to_matrix(R_t).numpy()
    maskd = np.asarray(J.tt_matrix_to_matrix(mask))
    assert np.abs(Rd * (1 - maskd)).max() <= 1e-4


@pytest.mark.parametrize("name,seed", [("corr_clust", 291), ("max_stable_set", 3)])
def test_create_problem_matches_jax(name, seed):
    jmod, tmod = {"corr_clust": (JCC, TCC), "max_stable_set": (JMSS, TMSS)}[name]
    np.random.seed(seed)
    out_j = jmod.create_problem(3, 1)
    np.random.seed(seed)
    out_t = tmod.create_problem(3, 1, device="cpu")
    assert len(out_t) == len(out_j) == (5 if name == "corr_clust" else 4)
    for got, want in zip(out_t, out_j):
        if isinstance(want, dict):
            assert set(got) == set(want) == {"y", "t"}
            for k in want:
                assert_same_train(got[k], want[k])
        else:
            assert_same_train(got, want)


# --- the fused algebra with inequalities ---------------------------------------

RANKS = {"00": (3, 2), "01": (2, 4), "12": (1, 1), "21": (4, 3), "22": (2, 2),
         "31": (1, 2), "33": (3, 1)}


def _operands(rng, left, right):
    pl = {k: rng.randn(left[0], RANKS[k][0], left[1]) for k in fa.INEQ_KEYS}
    pr = {k: rng.randn(right[0], RANKS[k][1], right[1]) for k in fa.INEQ_KEYS}
    A = {k: rng.randn(RANKS[k][0], 4, 4, RANKS[k][1]) for k in fa.INEQ_KEYS}
    return pl, A, pr


def _torch_dict(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


@pytest.mark.parametrize("kind", ["local", "z", "mixed_left", "mixed_right"])
def test_block_products_match_jax_algebra(kind, monkeypatch):
    """Nine terms on four rows, the (1,3) alias of the identity block and
    the dT row included, from one K2 call a product."""
    alg = make_algebra(np.einsum, np, lambda ineq: fa.INEQ_KEYS, lambda ineq: 4)
    rng = np.random.RandomState(40)
    left, right = {"local": ((5, 5), (3, 3)), "z": ((2, 5), (4, 3)),
                   "mixed_left": ((2, 5), (3, 3)), "mixed_right": ((5, 5), (4, 3))}[kind]
    pl, A, pr = _operands(rng, left, right)
    if kind in ("z", "mixed_left"):
        pl["10"] = rng.randn(left[0], RANKS["01"][0], 5)
    if kind in ("z", "mixed_right"):
        pr["10"] = rng.randn(right[0], RANKS["01"][1], 3)
    x = rng.randn(5, 4, 4, 3)
    spy = Spy(monkeypatch)
    args = b1((_torch_dict(pl), _torch_dict(A), _torch_dict(pr), torch.as_tensor(x)))
    if kind == "local":
        want, got = alg.local_product(pl, A, pr, x, True), fb.local_product(*args, ineq=True)[0]
    elif kind == "z":
        want, got = alg.z_product(pl, A, pr, x, True), fb.z_product(*args, ineq=True)[0]
    else:
        flag = kind == "mixed_right"
        want = alg.mixed_product(pl, pr, A, x, True, flag)
        got = fb.mixed_product(args[0], args[2], args[1], args[3], flag, ineq=True)[0]
    assert dict(spy.k2) == {(9, 4): 1}
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) < 1e-12


def test_project_rhs_matches_jax_algebra():
    alg = make_algebra(np.einsum, np, lambda ineq: fa.INEQ_KEYS, lambda ineq: 4)
    rng = np.random.RandomState(41)
    bl = [rng.randn(2, 5) for _ in range(4)]
    b = [rng.randn(2, 4, 3) for _ in range(4)]
    br = [rng.randn(3, 3) for _ in range(4)]
    want = alg.project_rhs(bl, b, br, True)
    got = fb.project_rhs(*b1(([torch.as_tensor(v) for v in bl], [torch.as_tensor(v) for v in b],
                              [torch.as_tensor(v) for v in br])), ineq=True)[0]
    assert tuple(got.shape) == want.shape == (5, 4, 4, 3)
    assert rel(got.numpy(), want) < 1e-12


def _local_operands(rl, rr, seed):
    """The interfaces of the middle core of a d3 inequality KKT system
    (tests/test_fused.py:390) between random orthonormal outer cores, so
    that the projected L_Z is SPD; numpy arrays, keyed as the fused
    algebra keys them."""
    rng = np.random.RandomState(seed)
    lhs, rhs = _make_ineq_kkt_system(3, rng)
    key_map = TF._KEY_MAP
    x0 = np.linalg.qr(rng.randn(4, rl))[0].reshape(1, 4, rl)
    x2 = np.linalg.qr(rng.randn(4, rr))[0].T.reshape(rr, 4, 1)
    one3, one2 = np.ones((1, 1, 1)), np.ones((1, 1))
    pl, A, pr = {}, {}, {}
    for k in fa.INEQ_KEYS:
        cores = [np.array(c) for c in lhs._data[key_map[k]]]
        pl[k] = np.einsum("lsr,lML,sMNS,rNR->LSR", one3, x0, cores[0], x0)
        A[k] = cores[1]
        pr[k] = np.einsum("LSR,lML,sMNS,rNR->lsr", one3, x2, cores[2], x2)
    bl, b, br = [], [], []
    for i in range(4):
        cores = [np.array(c) for c in rhs.get_row(i)]
        bl.append(np.einsum("br,bnB,rnR->BR", one2, cores[0], x0))
        b.append(cores[1])
        br.append(np.einsum("BR,bnB,rnR->br", one2, cores[2], x2))
    prev = rng.randn(rl, 4, 4, rr)
    return pl, A, pr, bl, b, br, prev


def test_dense_factor_and_apply_match_host_engine(monkeypatch):
    """The fused inequality Schur chain (Tikhonov on L_Z and on the Y
    system, LU of D) against the JAX host engine's; its six blocks come
    from one K1 group."""
    pl, A, pr, bl, b, br, prev = _local_operands(4, 3, 42)
    rhs_j = JH._project_rhs(bl, b, br, True)
    inv_j = 1.0 / JH._den_clamp(np.einsum("lsr,smnS,LSR->lmL", pl["12"], A["12"], pr["12"]))
    want = JH._dense_apply(JH._dense_factor(pl, A, pr, inv_j, True), pl, A, pr, inv_j, rhs_j,
                           True)
    plt, At, prt = b1((_torch_dict(pl), _torch_dict(A), _torch_dict(pr)))
    inv_t = b1(torch.as_tensor(inv_j))
    spy = Spy(monkeypatch)
    fac = fb._dense_factor(plt, At, prt, inv_t, ineq=True)
    assert dict(spy.k1) == {6: 1}
    got = fb._dense_apply(fac, plt, At, prt, inv_t, b1(torch.as_tensor(rhs_j)), ineq=True)[0]
    assert tuple(got.shape) == want.shape == (4, 4, 4, 3)
    assert rel(got.numpy(), want) < 1e-9

    rows = (b1([torch.as_tensor(v) for v in vs]) for vs in (bl, b, br))
    sol_t, old_t, min_t, _ = (v[0] for v in fb.solve_local(
        plt, At, prt, *rows, b1(torch.as_tensor(prev)), ineq=True))
    sol_j, _, old_j, min_j, _ = JH._solve_local(pl, A, pr, bl, b, br, prev, True)
    assert rel(sol_t.numpy(), sol_j) < 1e-9
    assert float(old_t) == pytest.approx(old_j, rel=1e-10)
    assert float(min_t) == pytest.approx(min_j, rel=1e-6, abs=1e-12)


def test_fused_amen_solves_ineq_system(monkeypatch):
    """tt_block_amen_fused(ineq=True) on the synthetic inequality system of
    tests/test_fused.py:390 (d3, R=16) to a relative residual < 1e-5; every
    local product is one nine-term K2 call and every factor one K1 group of
    six."""
    rng = np.random.RandomState(9)
    lhs, rhs = _make_ineq_kkt_system(3, rng)
    lhs_t = block_matrix_to_torch({k: [np.asarray(c) for c in v] for k, v in lhs._data.items()},
                                  lhs._aliases, lhs._transposes, device="cpu")
    rhs_t = block_vector_to_torch({i: [np.asarray(c) for c in v] for i, v in rhs.items()},
                                  device="cpu")
    spy = Spy(monkeypatch)
    x, _ = TF.tt_block_amen_fused(lhs_t, rhs_t, 1e-8, R=16, nswp=20, ineq=True,
                                  rng=np.random.RandomState(7))
    assert set(spy.k2) == {(9, 4)} and set(spy.k1) == {6}
    rn = TF.fused_residual_norm(TF.prep_operator(lhs_t, True),
                                TF.prep_rhs(rhs_t, len(x), x[0], True), x, True)
    assert rn / rhs_t.norm < 1e-5


# --- smallest-eigenvector sweeps ---------------------------------------------

def test_fused_min_eig_matches_dense_and_jax():
    """tests/test_fused.py:222: a random symmetric d3 operator."""
    from ttipm_tpu.solvers.fused_eigen import tt_min_eig_fused as min_eig_fused_j

    sym = tt_rank_reduce(
        [0.5 * (c + np.swapaxes(np.asarray(c), 1, 2))
         for c in tt_random_gaussian([2] * 2, (2, 2))], 1e-12)
    M = np.asarray(J.tt_matrix_to_matrix(sym))
    lam_true = np.linalg.eigvalsh(0.5 * (M + M.T))[0]
    np.random.seed(1)
    _, lam_j = min_eig_fused_j(sym, tol=1e-10, return_eig_val=True)
    np.random.seed(1)
    x, lam = min_eig_fused_t(tt_t(sym), tol=1e-10, return_eig_val=True)
    assert np.isclose(lam, lam_true, rtol=1e-5, atol=1e-8)
    assert lam == pytest.approx(float(lam_j), rel=1e-8)
    assert T.tt_norm(x) == pytest.approx(1.0, rel=1e-12)


def test_ragged_min_eig_matches_min_entry_and_jax():
    """tests/test_eigen.py:89: the smallest eigenvector of Diag(M)
    localises on the minimum entry of M."""
    from ttipm_tpu.ops.tt import tt_diag_op
    from ttipm_tpu.solvers.eigen import tt_min_eig as min_eig_j

    M = sym_tt(4, 2)
    op = tt_diag_op(M, 1e-12)
    np.random.seed(2)
    _, val_j = min_eig_j(op, tol=1e-9, return_eig_val=True)
    np.random.seed(2)
    _, val = min_eig_t(tt_t(op), tol=1e-9, return_eig_val=True)
    assert abs(val - np.asarray(J.tt_matrix_to_matrix(M)).min()) < 1e-5
    assert val == pytest.approx(float(val_j), rel=1e-8)


# --- the ragged local KKT solver with inequalities ------------------------------

@pytest.fixture(scope="module")
def first_ineq_local_system():
    """The arguments of the first ragged local solve of corr_clust d3 seed
    291 with the fused ladder forced to exhaust, in the JAX package."""
    import ttipm_tpu.ipm as jipm
    import ttipm_tpu.solvers.fused as jfused

    captured = {}

    def exhausted(*a, **k):
        raise JA.AmenRestartsExhausted("synthetic exhaustion")

    def capture(*args):
        captured["args"] = args
        raise _Captured()

    saved = (jfused.tt_restarted_block_amen_fused, jipm.ipm_local_solver_ineq,
             jconfig.fused_kkt(), jconfig.rank_bucket())
    jfused.tt_restarted_block_amen_fused = exhausted
    jipm.ipm_local_solver_ineq = capture
    jconfig.set_fused_kkt(True)
    jconfig.set_rank_bucket(1)
    try:
        np.random.seed(291)
        obj, L, b, mask, lag = JCC.create_problem(3, 1)
        with pytest.raises(_Captured):
            jipm.tt_ipm(lag, obj, L, b, ineq_mask=mask, **CC_SETTINGS)
    finally:
        jfused.tt_restarted_block_amen_fused, jipm.ipm_local_solver_ineq = saved[:2]
        jconfig.set_fused_kkt(saved[2])
        jconfig.set_rank_bucket(saved[3])
    return captured["args"]


def capture_fused_solve(name, dim, seed, settings, call):
    """The arguments of the JAX package's ``call``-th fused ladder solve
    (from 1) in the solve of that seeded instance, and numpy's global
    RandomState at that point."""
    import ttipm_tpu.solvers.fused as jfused

    jmod = {"corr_clust": JCC, "max_stable_set": JMSS}[name]
    captured, count, ladder = {}, [0], jfused.tt_restarted_block_amen_fused

    def capture(A, b, **kw):
        count[0] += 1
        if count[0] < call:
            return ladder(A, b, **kw)
        captured.update(A=A, b=b, kw=kw, state=np.random.get_state())
        raise _Captured()

    jfused.tt_restarted_block_amen_fused = capture
    try:
        np.random.seed(seed)
        out = jmod.create_problem(dim, 1)
        mask, lag = (out[3], out[4]) if len(out) == 5 else (None, {"y": J.tt_reshape(out[3], (4, 4))})
        with pytest.raises(_Captured):
            ipm_j(lag, *out[:3], ineq_mask=mask, **settings)
    finally:
        jfused.tt_restarted_block_amen_fused = ladder
    return captured


def replay_fused_solve(captured, port=True, numpy_svd=False, verbose=False):
    """A captured solve through the port's fused ladder (``numpy_svd``: with
    numpy's SVD in its split steps) or the JAX package's, from the captured
    numpy state; returns (the solution as one dense array, its residual,
    res_old of every local solve)."""
    import ttipm_tpu.solvers.fused as jfused
    import ttipm_tpu.solvers.fused_host as JH

    A, b, kw = captured["A"], captured["b"], dict(captured["kw"], verbose=verbose)
    # the port's local solve is the batched one, on a batch of one
    module, name = (fb, "solve_local") if port else (JH, "_solve_local")
    local, svd, res_old = getattr(module, name), fb.fast_split_svd, []

    def spy(*args, **kw_local):
        out = local(*args, **kw_local)
        res_old.append(float(out[1][0]) if port else float(out[2]))
        return out

    def np_svd(a):
        return tuple(torch.from_numpy(t) for t in np.linalg.svd(a.numpy(), full_matrices=False))

    setattr(module, name, spy)
    if numpy_svd:
        fb.fast_split_svd = np_svd
    np.random.set_state(captured["state"])
    try:
        if port:
            if kw.get("x0") is not None:
                kw["x0"] = tt_t(kw["x0"])
            x, res = TF.tt_restarted_block_amen_fused(
                block_matrix_to_torch({k: [np.asarray(c) for c in v] for k, v in A._data.items()},
                                      A._aliases, A._transposes, device="cpu"),
                block_vector_to_torch({i: [np.asarray(c) for c in v] for i, v in b.items()},
                                      device="cpu"), **kw)
            x = tt_to_numpy(x)
        else:
            x, res = jfused.tt_restarted_block_amen_fused(A, b, **kw)
    finally:
        setattr(module, name, local)
        fb.fast_split_svd = svd
    return full(x), float(res), res_old


def test_fused_ladder_ineq_matches_jax():
    """The JAX package's first Newton system of corr_clust d3 seed 291 (the
    inequality system) through both fused ladders."""
    jconfig.set_rank_bucket(1)
    captured = capture_fused_solve("corr_clust", 3, 291, CC_SETTINGS, 1)
    assert captured["kw"]["ineq"]
    x_j, res_j, old_j = replay_fused_solve(captured, port=False)
    x_t, res_t, old_t = replay_fused_solve(captured)
    assert len(old_t) == len(old_j) > 0
    # relative residuals: 1e-8 apart, or both at the solve's floor (~2e-11)
    assert np.allclose(old_t, old_j, rtol=1e-8, atol=1e-13)
    # the returned residuals sit at the floor of the expanded-norm formula
    # (its cancellation gives 0.0 in one package, 2e-11 in the other)
    assert max(res_t, res_j) < 1e-9
    assert rel(x_t, x_j) < 1e-8


@pytest.mark.parametrize("dense", [True, False])
def test_local_solver_ineq_matches_jax(first_ineq_local_system, dense, monkeypatch):
    from ttipm_tpu.solvers.local_kkt import ipm_local_solver_ineq as local_j

    args = first_ineq_local_system
    assert args[6].shape[1] == 4
    out_j = local_j(*args[:8], dense)
    spy = Spy(monkeypatch)
    out_t = TK.ipm_local_solver_ineq(*_port_args(args), dense)
    sol_j, old_j, new_j, rhs_j, nrm_j, fail_j = out_j
    sol_t, old_t, new_t, rhs_t, nrm_t, fail_t = out_t
    assert fail_t == fail_j == (not dense)
    if dense:
        assert dict(spy.k1) == {6: 1}
    else:
        assert spy.k2[(6, 3)] > 0 and not spy.k1
    scale = float(np.linalg.norm(np.asarray(rhs_j)))
    assert float(torch.linalg.norm(rhs_t - torch.from_numpy(np.array(rhs_j)))) <= 1e-10 * scale
    assert float(torch.linalg.norm(sol_t - torch.from_numpy(np.array(sol_j)))) <= 1e-10 * scale
    assert nrm_t == pytest.approx(nrm_j, rel=1e-10)
    assert abs(old_t - old_j) <= 1e-10 and abs(new_t - new_j) <= 1e-10


# --- end to end ----------------------------------------------------------------

def config_settings(name):
    """The IPM settings of configs/<name>.yaml, as the runner passes them."""
    from ttipm_tpu_torch.utils.runner import load_yaml

    c = load_yaml(os.path.join(REPO, "configs", f"{name}.yaml"))
    return dict(max_iter=c["max_iter"], gap_tol=float(c["gap_tol"]),
                op_tol=float(c["op_tol"]), abs_tol=float(c["abs_tol"]), warm_up=c["warm_up"],
                aho_direction=False, mals_restarts=c["mals_restarts"],
                max_refinement=c["max_refinement"], lambdaStar=float(c.get("lambdaStar", 1)),
                lambdaStarIneq=float(c.get("lambdaStarIneq", 1)))


def _solve_pair(name, dim, seed, settings):
    """The same seeded instance solved by both packages on the CPU; returns
    per package (X, Y, T, Z, info, <C, X>) and the port's problem."""
    jmod, tmod = {"corr_clust": (JCC, TCC), "max_stable_set": (JMSS, TMSS)}[name]

    def lags(out, tt):
        if len(out) == 5:
            return out[:3], out[3], out[4]
        return out[:3], None, {"y": tt.tt_reshape(out[3], (4, 4))}

    np.random.seed(seed)
    (obj_j, L_j, b_j), mask_j, lag_j = lags(jmod.create_problem(dim, 1), J)
    out_j = ipm_j(lag_j, obj_j, L_j, b_j, ineq_mask=mask_j, **settings)
    np.random.seed(seed)
    (obj_t, L_t, b_t), mask_t, lag_t = lags(tmod.create_problem(dim, 1, device="cpu"), T)
    out_t = ipm_t(lag_t, obj_t, L_t, b_t, ineq_mask=mask_t, **settings)
    cx_j = J.tt_inner_prod(J.tt_reshape(obj_j, (2, 2)), out_j[0])
    cx_t = T.tt_inner_prod(T.tt_reshape(obj_t, (2, 2)), out_t[0])
    return (*out_j, cx_j), (*out_t, cx_t), (obj_t, L_t, b_t, mask_t)


def _solve_both(name, dim, seed, settings):
    """``_solve_pair`` held to the same iterations, ineq_status and ranks,
    and the port's solve to slackness and feasibility < 1e-3."""
    jax_out, port_out, (obj, L, b, mask) = _solve_pair(name, dim, seed, settings)
    info_j, cx_j = jax_out[4:]
    X_t, Y_t, T_t, Z_t, info_t, cx_t = port_out
    st_t = info_t["status"]
    assert info_t["num_iters"] == info_j["num_iters"]
    assert st_t.ineq_status.name == info_j["status"].ineq_status.name
    for key in ("ranksX", "ranksZ", "ranksT"):
        assert info_t[key] == info_j[key], key
    active = st_t.ineq_status is IneqStatus.ACTIVE
    metrics = solve_metrics(X_t, Y_t, Z_t, obj, L, b, T=T_t, ineq_active=active)
    assert max(metrics) < 1e-3, metrics
    return cx_j, cx_t, mask, X_t, T_t, st_t


def _mask_conditions(mask, X, Tm):
    """tests/test_ipm_e2e.py:196-204: X above the barrier on the mask, T
    supported on the mask only."""
    Xd = T.tt_matrix_to_matrix(X).numpy()
    maskd = T.tt_matrix_to_matrix(mask).numpy()
    assert Xd[maskd > 0.5].min() > -1e-2
    if Tm is not None:
        assert np.abs(T.tt_matrix_to_matrix(Tm).numpy()[maskd < 0.5]).max() < 1e-6


def test_corr_clust_d3_matches_jax(monkeypatch):
    spy = Spy(monkeypatch)
    cx_j, cx_t, mask, X, Tm, status = _solve_both("corr_clust", 3, 291, CC_SETTINGS)
    assert status.ineq_status is not IneqStatus.NOT_IN_USE
    assert cx_t == pytest.approx(cx_j, rel=1e-6)
    _mask_conditions(mask, X, Tm)
    assert spy.k2[(9, 4)] > 0 and spy.k1[6] > 0


@pytest.fixture(scope="module")
def ragged_corr_clust_d2():
    """The JAX package's fully ragged corr_clust d2 seed 11 solve."""
    jconfig.set_fused_kkt(False)
    try:
        np.random.seed(11)
        obj, L, b, mask, lag = JCC.create_problem(2, 1)
        X, _, _, _, info = ipm_j(lag, obj, L, b, ineq_mask=mask, **CC_SETTINGS)
    finally:
        jconfig.set_fused_kkt(True)
    return J.tt_inner_prod(J.tt_reshape(obj, (2, 2)), X), info


def test_fully_ragged_corr_clust_d2_matches_jax(ragged_corr_clust_d2, monkeypatch):
    import ttipm_tpu_torch.ipm as tipm

    def no_fused(*a, **k):
        raise AssertionError("a fused solver ran with fused_kkt off")

    for name in ("tt_restarted_block_amen_fused", "tt_max_generalised_eigen_fused",
                 "tt_min_eig_fused"):
        monkeypatch.setattr(tipm, name, no_fused)
    tconfig.set_fused_kkt(False)
    cx_j, info_j = ragged_corr_clust_d2
    np.random.seed(11)
    obj, L, b, mask, lag = TCC.create_problem(2, 1, device="cpu")
    X, Y, Tm, Z, info = ipm_t(lag, obj, L, b, ineq_mask=mask, **CC_SETTINGS)
    assert info["num_iters"] == info_j["num_iters"]
    assert info["status"].ineq_status.name == info_j["status"].ineq_status.name
    for key in ("ranksX", "ranksZ", "ranksT"):
        assert info[key] == info_j[key], key
    assert T.tt_inner_prod(T.tt_reshape(obj, (2, 2)), X) == pytest.approx(cx_j, rel=1e-6)
    active = info["status"].ineq_status is IneqStatus.ACTIVE
    assert max(solve_metrics(X, Y, Z, obj, L, b, T=Tm, ineq_active=active)) < 1e-3
    _mask_conditions(mask, X, Tm)


def test_max_stable_set_d3_matches_jax():
    """Equality constraints only (no mask).  The two packages' <C, X> differ
    by 6e-7 relative (the finishing steps' roundings at slackness ~7e-4),
    inside the 1e-6 held here."""
    cx_j, cx_t, mask, _, Tm, status = _solve_both("max_stable_set", 3, 3, SETTINGS)
    assert mask is None and Tm is None and status.ineq_status is IneqStatus.NOT_IN_USE
    assert cx_t == pytest.approx(cx_j, rel=1e-6)


def test_max_stable_set_d4_config_matches_jax():
    """configs/max_stable_set_6.yaml's settings (lambdaStar 2) at d4, seed
    384 (the seed of that config which diverges at d6 on the card)."""
    cx_j, cx_t, *_ = _solve_both("max_stable_set", 4, 384, config_settings("max_stable_set_6"))
    assert cx_t == pytest.approx(cx_j, rel=1e-6)


def main(argv):
    jconfig.set_rank_bucket(1)
    tconfig.set_rank_bucket(1)
    if argv[0] == "replay":
        problem, config, dim, seed, call = argv[1], argv[2], int(argv[3]), int(argv[4]), int(argv[5])
        captured = capture_fused_solve(problem, dim, seed, config_settings(config), call)
        for label, kw in (("jax", {"port": False}), ("port", {}),
                          ("port with numpy's SVD", {"numpy_svd": True})):
            print(f"--- {label}", flush=True)
            replay_fused_solve(captured, verbose=True, **kw)
        return
    verbose = "--verbose" in argv  # each package's per-iteration log
    argv = [a for a in argv if a != "--verbose"]
    problem, config, dim, seeds = argv[0], argv[1], int(argv[2]), argv[3].split(",")
    for seed in map(int, seeds):
        outs = _solve_pair(problem, dim, seed, {**config_settings(config), "verbose": verbose})[:2]
        for pkg, (X, _, _, Z, info, cx), tt in zip(("jax", "port"), outs, (J, T)):
            print(f"{problem} d{dim} seed {seed} {pkg}: {info['num_iters']} iterations, "
                  f"slackness {abs(float(tt.tt_inner_prod(X, Z))):.4e}, ranks X "
                  f"{info['ranksX']} Z {info['ranksZ']} T {info['ranksT']}, <C,X> {float(cx)!r}",
                  flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
