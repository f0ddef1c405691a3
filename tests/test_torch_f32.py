"""The float32 profile of the port against the JAX package's (its numpy host
engine, the CPU default), on the CPU, each case at rank bucket 1.

The profile is ``bench.py``'s offload-f32 numerics: ``set_dtype(float32)``
(eps floor 1e-7), ``set_eigen_dtype("native")`` and the mixed-precision
local solves (default ``"f64"``).  Inputs are made from numpy seeds; JAX
trains are carried over with ``interop.tt_to_torch(..., dtype=float32)``.
Each case states its tolerance:

* the profile switches, the eps floor and ``clamp_eps``
  (``tests/test_f32_profile.py:24``);
* ``den_clamp``, ``tikhonov`` and ``column_scales`` in f32 against
  ``make_algebra(..., np, ...)`` (the same f32 arithmetic: 1e-6 relative);
* each kernel's plain f32 version against the Pallas kernel in interpret
  mode in f32 (as ``tests/test_kernels.py`` runs them): K1 and K2 1e-5
  relative, K3's and K4's factors by their residuals (the Pallas QR
  reflects columns LAPACK leaves, and its Cholesky clamps pivots);
* the f32 split SVD on the rank-deficient gallery of
  ``tests/test_jacobi.py:114-139`` (``torch.linalg.svd`` keeps u
  orthonormal at zero singular values; no Gram split is needed on the CPU);
* the fused local solve (``fused_batch.solve_local`` on a batch of one)
  in "f64", "refine" and "off" on a local system of the captured maxcut
  d3 Newton system cast to f32, against
  ``fused_host._solve_local`` on the same f32 operands;
* the f32 fused KKT solve of ``tests/test_f32_profile.py:30`` (relative
  residual < 1e-3 in both packages);
* the f32 pencil branches (``:51``), and the native-eigen step size within
  5e-3 of the f64 one (``tests/test_fused.py:321-356``);
* maxcut d3 seed 319 in f32 end to end in both packages: both converge,
  iterations within one, equal final ranks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttipm_tpu import config as jconfig
from ttipm_tpu.ops import tt as J
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.interop import (
    block_matrix_to_torch,
    block_vector_to_torch,
    tt_to_numpy,
    tt_to_torch,
)
from ttipm_tpu_torch.ops import kernels as K

F32 = torch.float32


@pytest.fixture
def f32_profile():
    """Both packages in the f32 profile (native eigen pencils, f64 local
    solves) at rank bucket 1; the f64 profile restored after."""
    jconfig.set_rank_bucket(1)
    tconfig.set_rank_bucket(1)
    jconfig.set_dtype(jnp.float32)
    tconfig.set_dtype(F32)
    jconfig.set_eigen_dtype("native")
    tconfig.set_eigen_dtype("native")
    yield
    for cfg, f64 in ((jconfig, jnp.float64), (tconfig, torch.float64)):
        cfg.set_dtype(f64)
        cfg.set_eigen_dtype("f64")
        cfg.set_mixed_local("f64")
    tconfig.set_rank_bucket(4)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_profile_switches_and_eps_floor(f32_profile):
    assert tconfig.dtype() == F32 and tconfig.tf32_off()
    assert tconfig.clamp_eps(1e-12) == pytest.approx(1e-7)
    assert tconfig.clamp_eps(1e-3) == pytest.approx(1e-3)
    assert tconfig.clamp_eps(1e-12) == pytest.approx(jconfig.clamp_eps(1e-12), rel=1e-12)
    assert tconfig.eigen_dtype() == F32 and tconfig.mixed_local() == "f64"
    for mode, want in (("refine", "refine"), (True, "refine"), ("off", "off"),
                       (False, "off"), (None, "off"), ("f64", "f64")):
        tconfig.set_mixed_local(mode)
        jconfig.set_mixed_local(mode)
        assert tconfig.mixed_local() == jconfig.mixed_local() == want
    with pytest.raises(ValueError):
        tconfig.set_mixed_local("f16")
    with pytest.raises(ValueError):
        tconfig.set_eigen_dtype("f32")
    with pytest.raises(ValueError):
        tconfig.set_dtype(torch.float16)
    with tconfig.profile(torch.float64):
        assert tconfig.dtype() == torch.float64 and tconfig.clamp_eps(1e-12) == 1e-12
    assert tconfig.dtype() == F32 and tconfig.clamp_eps(1e-12) == pytest.approx(1e-7)
    tconfig.set_eigen_dtype("f64")
    assert tconfig.eigen_dtype() == torch.float64


def test_algebra_floors_f32_match_the_jax_package():
    """The f32 floors of the fused algebra: relative 1e-6 for den_clamp,
    1e-6 max|S| + 1e-11 Tikhonov, 1e-5 column scales; the same f32
    arithmetic in both, so 1e-6 relative."""
    from ttipm_tpu.solvers.fused_host import _ALG
    from ttipm_tpu_torch.solvers import fused_algebra as fa
    from ttipm_tpu_torch.solvers import fused_batch as fb

    rng = np.random.RandomState(3)
    den = rng.randn(3, 4, 5).astype(np.float32)
    den[0, 0, :] = 1e-9  # below the f32 floor
    S = rng.randn(12, 12).astype(np.float32)
    core = rng.randn(2, 3, 4, 2).astype(np.float32)
    core[:, 1] *= 1e-8  # a dead block column
    # the fused solve's (a batch of one) and the ragged solvers' single ones
    fns = [(name, lambda a, f=getattr(fb, name): f(a.unsqueeze(0))[0])
           for name in ("den_clamp", "tikhonov", "column_scales")]
    fns += [(name, getattr(fa, name)) for name in ("tikhonov", "column_scales")]
    for name, fn in fns:
        arg = {"den_clamp": den, "tikhonov": S, "column_scales": core}[name]
        want = getattr(_ALG, name)(arg)
        got = fn(torch.as_tensor(arg))
        assert got.dtype == F32 and want.dtype == np.float32, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0, err_msg=name)
    # the f32 floors are in force, not the f64 ones
    assert (float(fb.den_clamp(torch.as_tensor(den)[None]).abs().min())
            >= 1e-6 * np.abs(den).max() * 0.99)
    assert float(fb.column_scales(torch.as_tensor(core)[None])[0, 0, 1, 0, 0]) > 1e-6


@pytest.mark.parametrize("kernel", ["kkt_block_matvec", "schur_assemble", "panel_qr",
                                    "panel_cholesky"])
def test_plain_f32_kernels_match_pallas(kernel):
    """The plain f32 version of each kernel against the Pallas kernel in
    interpret mode in f32: K1 and K2 1e-5 relative (f32 sums in another
    order); K3 and K4 by their factorization residuals, 5e-6 relative (a
    few ulps of f32 per step at these sizes), and K4's factor itself to
    1e-5 of the Pallas one."""
    from ttipm_tpu.ops import kernels as JK

    rng = np.random.RandomState(17)
    if kernel == "kkt_block_matvec":
        ops = [rng.randn(*s).astype(np.float32)
               for s in ((6, 3, 5), (3, 4, 4, 2), (7, 2, 4), (5, 4, 4))]
        want = np.asarray(JK.kkt_block_matvec(*map(jnp.asarray, ops), interpret=True))
        got = K.kkt_block_matvec(*map(torch.as_tensor, ops))
        assert got.dtype == F32 and want.dtype == np.float32
        assert rel(got.numpy(), want) < 1e-5
    elif kernel == "schur_assemble":
        ops = [rng.randn(*s).astype(np.float32) for s in ((8, 5, 8), (5, 4, 4, 6), (8, 6, 8))]
        want = np.asarray(JK.schur_assemble(*map(jnp.asarray, ops), interpret=True))
        got = K.schur_assemble(*map(torch.as_tensor, ops))
        assert got.dtype == F32 and want.dtype == np.float32
        assert rel(got.numpy(), want) < 1e-5
    elif kernel == "panel_qr":
        a = rng.randn(40, 10).astype(np.float32)
        for q, r in ((np.asarray(t) for t in JK.panel_qr(jnp.asarray(a), interpret=True)),
                     (t.numpy() for t in K.panel_qr(torch.as_tensor(a)))):
            assert q.dtype == np.float32
            qd, rd = q.astype(np.float64), r.astype(np.float64)
            assert rel(qd @ rd, a) < 5e-6
            assert np.abs(qd.T @ qd - np.eye(10)).max() < 5e-6
            assert np.abs(np.tril(r, -1)).max() == 0.0
    else:
        B = rng.randn(48, 48).astype(np.float32)
        A = B @ B.T + 48 * np.eye(48, dtype=np.float32)
        Lj = np.asarray(JK.panel_cholesky(jnp.asarray(A), interpret=True))
        L, info = K.panel_cholesky(torch.as_tensor(A))
        assert int(info) == 0 and L.dtype == F32
        Ld = L.numpy().astype(np.float64)
        assert rel(Ld @ Ld.T, A) < 5e-6
        assert np.abs(L.numpy() - Lj).max() < 1e-5 * np.abs(Lj).max()


@pytest.mark.parametrize("svd", ["torch.linalg.svd", "fast_split_svd"])
def test_f32_split_svd_keeps_u_orthonormal_at_zero_singular_values(svd):
    """tests/test_jacobi.py:114-139's gallery, exact rank 3 of (4, 24) and
    its transpose, on torch's f32 SVD and on the port's split SVD (which
    rounds an f64 SVD to f32): u orthonormal to 1e-5, vt bounded, the split
    exact to 1e-4 (XLA:CPU's f32 SVD gave ~1e26 left vectors there, which
    made the JAX package take a Gram split; torch's does not); the port's
    f32 factors equal the f64 ones rounded."""
    from ttipm_tpu_torch.ops.linalg import fast_split_svd

    fn = fast_split_svd if svd == "fast_split_svd" else \
        (lambda t: torch.linalg.svd(t, full_matrices=False))
    rng = np.random.RandomState(5)
    base = rng.randn(4, 24).astype(np.float32)
    u0, s0, vt0 = np.linalg.svd(base, full_matrices=False)
    s0[3] = 0.0
    for a in (u0 @ np.diag(s0) @ vt0, (u0 @ np.diag(s0) @ vt0).T):
        at = torch.as_tensor(np.ascontiguousarray(a))
        got = fn(at)
        assert all(t.dtype == F32 for t in got)
        u, s, vt = (t.numpy().astype(np.float64) for t in got)
        assert np.abs(u).max() < 1.5
        assert np.abs(u.T @ u - np.eye(u.shape[1])).max() < 1e-5
        assert np.abs(vt).max() < 1e3
        assert np.abs(u @ (s[:, None] * vt) - a).max() < 1e-4 * max(1.0, np.abs(a).max())
        if svd == "fast_split_svd":
            want = torch.linalg.svd(at.double(), full_matrices=False)
            assert all(torch.equal(g, w.float()) for g, w in zip(got, want))


def _local_system(dim=3, r=3, seed=2):
    """The local KKT system at core 0 of the JAX package's first maxcut d3
    Newton system (``__graft_entry__._capture_first_newton_system``), cast
    to f32: the right interfaces of a random right-orthonormal basis of
    ranks r, the block axis on core 0, and a random previous core."""
    from __graft_entry__ import _capture_first_newton_system
    from ttipm_tpu_torch.solvers import fused as TF
    from ttipm_tpu_torch.solvers import fused_algebra as fa

    lhs, rhs = _capture_first_newton_system(dim=dim)
    lhs_t = block_matrix_to_torch({k: [np.asarray(c) for c in v] for k, v in lhs._data.items()},
                                  lhs._aliases, lhs._transposes, device="cpu", dtype=F32)
    rhs_t = block_vector_to_torch({i: [np.asarray(c) for c in v] for i, v in rhs.items()},
                                  device="cpu", dtype=F32)
    A = TF.prep_operator(lhs_t)
    b = TF.prep_rhs(rhs_t, dim, next(iter(rhs_t.values()))[0])
    rng = np.random.RandomState(seed)
    x2 = torch.linalg.qr(torch.as_tensor(rng.randn(4, r), dtype=F32))[0].T.reshape(r, 4, 1)
    x1 = torch.linalg.qr(torch.as_tensor(rng.randn(4 * r, r), dtype=F32))[0].T.reshape(r, 4, r)
    ones3, ones2 = torch.ones((1, 1, 1), dtype=F32), torch.ones((1, 1), dtype=F32)
    pr, br = {k: ones3 for k in fa.keys(False)}, [ones2] * 3
    for k, xc in ((2, x2), (1, x1)):
        pr = {key: fa.phi_bck_A(pr[key], xc, A[key][k], xc) for key in fa.keys(False)}
        br = [fa.phi_bck_rhs(br[i], b[i][k], xc) for i in range(3)]
    pl = {k: ones3 for k in fa.keys(False)}
    A0 = {k: A[k][0] for k in fa.keys(False)}
    b0 = [b[i][0] for i in range(3)]
    prev = torch.as_tensor(rng.randn(1, 3, 4, r) * 0.1, dtype=F32)
    return pl, A0, pr, [ones2] * 3, b0, br, prev


# (mode, bound on the relative difference of the two packages' solutions)
# "f64": the same f64 chain on the same upcast operands, rounded to f32 at
# the end: a few f32 ulps at most.  "refine": f32 factorizations from two
# LAPACKs, then two f64-residual corrections, each gaining about the f32
# factor's accuracy: 1e-5.  "off": all f32; the Tikhonov-regularised Schur
# system amplifies the two LAPACKs' f32 rounding by its conditioning:
# 1e-4.  (Measured on this system: 0, 0 and 4.4e-8.)
LOCAL_MODES = [("f64", 1e-6), ("refine", 1e-5), ("off", 1e-4)]


@pytest.mark.parametrize("mode,bound", LOCAL_MODES, ids=[m for m, _ in LOCAL_MODES])
def test_solve_local_modes_match_the_host_engine(f32_profile, mode, bound):
    from ttipm_tpu.solvers import fused_host as FH
    from ttipm_tpu_torch.solvers import fused_batch as fb
    from ttipm_tpu_torch.solvers.fused_batch import batch_of_one as b1

    jconfig.set_mixed_local(mode)
    tconfig.set_mixed_local(mode)
    pl, A, pr, bl, b, br, prev = _local_system()
    K.reset_counts()
    sol, res_old, res_min, dx = (v[0] for v in fb.solve_local(*b1((pl, A, pr, bl, b, br, prev))))
    npy = lambda t: {k: v.numpy() for k, v in t.items()} if isinstance(t, dict) \
        else [v.numpy() for v in t]  # noqa: E731
    sol_j, _, res_old_j, res_min_j, dx_j = FH._solve_local(npy(pl), npy(A), npy(pr), npy(bl),
                                                           npy(b), npy(br), prev.numpy(), False)
    assert sol.dtype == F32 and sol_j.dtype == np.float32
    # the guard's residuals are formed in f64 in the mixed modes
    assert res_old.dtype == (F32 if mode == "off" else torch.float64)
    assert float(res_old) == pytest.approx(res_old_j, rel=1e-5)
    assert float(res_min) < float(res_old) and res_min_j < res_old_j
    if mode == "off":  # both at f32's floor (~4e-7 here): no closer agreement to hold
        assert float(res_min) < 1e-5 and res_min_j < 1e-5
    else:
        assert float(res_min) == pytest.approx(res_min_j, rel=1e-3)
    assert rel(sol.numpy(), sol_j) < bound
    # "f64" factors with the kernels' f64 instances, the other modes in f32
    st = K.STATS["panel_cholesky"]
    assert st.plain_calls == 1


def test_fused_kkt_solve_f32(f32_profile):
    """tests/test_f32_profile.py:30 in both packages: the solution is f32 and
    its relative residual below the f32 solver floor 1e-3."""
    from tests.test_fused import _make_kkt_system
    from ttipm_tpu.solvers.fused import _fused_residual_norm, _prep_operator, _prep_rhs
    from ttipm_tpu.solvers.fused import tt_block_amen_fused as solve_j
    from ttipm_tpu_torch.solvers import fused as TF

    rng = np.random.RandomState(1)
    d = 3
    lhs, rhs = _make_kkt_system(d, rng)
    x, _ = solve_j(lhs, rhs, 1e-5, R=12, ineq=False, nswp=12, seed=3)
    assert all(c.dtype == jnp.float32 for c in x)
    rn = _fused_residual_norm(_prep_operator(lhs, d, ineq=False), _prep_rhs(rhs, d, ineq=False),
                              list(x), ineq=False)
    assert rn / rhs.norm < 1e-3
    lhs_t = block_matrix_to_torch({k: [np.asarray(c) for c in v] for k, v in lhs._data.items()},
                                  lhs._aliases, lhs._transposes, device="cpu", dtype=F32)
    rhs_t = block_vector_to_torch({i: [np.asarray(c) for c in v] for i, v in rhs.items()},
                                  device="cpu", dtype=F32)
    x_t, _ = TF.tt_block_amen_fused(lhs_t, rhs_t, 1e-5, R=12, nswp=12,
                                    rng=np.random.RandomState(3))
    assert all(c.dtype == F32 for c in x_t)
    ref = next(iter(rhs_t.values()))[0]
    rn_t = TF.fused_residual_norm(TF.prep_operator(lhs_t), TF.prep_rhs(rhs_t, d, ref), x_t)
    assert rn_t / rhs_t.norm < 1e-3


def test_pencil_branches_f32(f32_profile):
    """tests/test_f32_profile.py:51: the pencil solve with a host-float
    alpha stays in f32 on both of its branches; the port's step and scale
    agree with the host engine's to 1e-4 (f32 eigensolvers)."""
    from ttipm_tpu.solvers.fused_eigen_host import _pencil_solve as pencil_j
    from ttipm_tpu_torch.solvers.fused_eigen import _pencil_solve as pencil_t

    rng = np.random.RandomState(0)
    m = 12
    Q = np.linalg.qr(rng.randn(m, m))[0]
    MA = (Q @ np.diag(np.linspace(1, 3, m)) @ Q.T).astype(np.float32)
    MD = (Q @ np.diag(np.linspace(-1, 2, m)) @ Q.T).astype(np.float32)
    prev = (rng.randn(m) / np.sqrt(m)).astype(np.float32)
    for alpha in (0.5, 2.0):  # PSD pencil (no shrink) and indefinite (shrink)
        x, a_new, old_res, scale = pencil_t(torch.as_tensor(MA), torch.as_tensor(MD),
                                            torch.as_tensor(prev), alpha, 1e-3)
        _, a_j, old_j, scale_j = pencil_j(MA, MD, prev, alpha, 1e-3)
        assert x.dtype == F32 and np.isfinite(a_new) and float(scale) > 0
        assert a_new == pytest.approx(a_j, rel=1e-4)
        assert float(old_res) == pytest.approx(old_j, rel=1e-4)
        assert float(scale) == pytest.approx(scale_j, rel=1e-5)
    assert a_new < 2.0  # the second pencil was shrunk


def test_native_eigen_step_within_5e3_of_f64():
    """tests/test_fused.py:321-356 on the port: the f32-native step-size
    eigensolve agrees with the f64 one to 5e-3 (the precision the IPM
    needs), and its pencils are f32 (K1 and K4's f32 instances on a card)."""
    from ttipm_tpu.ops.products import tt_fast_mat_mat_mul
    from ttipm_tpu.ops.random import tt_random_gaussian
    from ttipm_tpu_torch.solvers.fused_eigen import tt_max_generalised_eigen_fused as eig_t

    d = 4
    np.random.seed(11)
    B = tt_random_gaussian([2] * (d - 1), (2, 2))
    A_j = J.tt_add(tt_fast_mat_mat_mul(B, J.tt_transpose(B), 1e-12),
                   J.tt_scale(0.5, J.tt_identity(d)))
    np.random.seed(111)
    Dl = tt_random_gaussian([2] * (d - 1), (2, 2))
    D_j = J.tt_add(J.tt_add(J.tt_scale(0.5, Dl), J.tt_scale(0.5, J.tt_transpose(Dl))),
                   J.tt_scale(-0.3, J.tt_identity(d)))
    tconfig.set_rank_bucket(1)
    s64, _ = eig_t(tt_to_torch(tt_to_numpy(A_j), device="cpu"),
                   tt_to_torch(tt_to_numpy(D_j), device="cpu"), tol=1e-8,
                   rng=np.random.RandomState(7))
    tconfig.set_dtype(F32)
    tconfig.set_eigen_dtype("native")
    try:
        K.reset_counts()
        s32, x32 = eig_t(tt_to_torch(tt_to_numpy(A_j), device="cpu", dtype=F32),
                         tt_to_torch(tt_to_numpy(D_j), device="cpu", dtype=F32), tol=1e-8,
                         rng=np.random.RandomState(7))
    finally:
        tconfig.set_eigen_dtype("f64")
        tconfig.set_dtype(torch.float64)
        tconfig.set_rank_bucket(4)
    assert all(c.dtype == F32 for c in x32)
    assert K.STATS["schur_assemble"].plain_calls > 0
    assert abs(s32 - s64) < 5e-3 * max(abs(s64), 1.0)


def test_maxcut_d3_f32_end_to_end_matches_jax(f32_profile):
    """maxcut d3 seed 319 in f32 with tests/test_f32_profile.py:71-87's
    settings in both packages: both converge (slackness and feasibility
    < 1e-3), iterations within one, equal final ranks.  The port builds the
    f32 instance in f64 and rounds it (``models/maxcut.py``); at this seed
    that is the JAX package's f32 instance to 1e-7."""
    from ttipm_tpu.ipm import tt_ipm as ipm_j
    from ttipm_tpu.models.maxcut import create_problem as cp_j
    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import tt_ipm as ipm_t
    from ttipm_tpu_torch.models.maxcut import create_problem as cp_t
    from ttipm_tpu_torch.ops import tt as T

    settings = dict(max_iter=22, gap_tol=3e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                    aho_direction=False, mals_restarts=2, max_refinement=5, lambdaStar=1.0)
    np.random.seed(319)
    obj_j, L_j, b_j, lag_j = cp_j(3, 1)
    X_j, _, _, Z_j, info_j = ipm_j({"y": J.tt_reshape(lag_j, (4, 4))}, obj_j, L_j, b_j,
                                   **settings)
    np.random.seed(319)
    obj_t, L_t, b_t, lag_t = cp_t(3, 1, device="cpu", dtype=F32)
    dense = lambda tt: np.asarray(J.tt_matrix_to_matrix(J.tt_reshape(  # noqa: E731
        [np.asarray(c, np.float64) for c in tt], (2, 2))))
    assert np.abs(dense(tt_to_numpy(obj_t)) - dense(obj_j)).max() < 1e-6
    X_t, Y_t, _, Z_t, info_t = ipm_t({"y": T.tt_reshape(lag_t, (4, 4))}, obj_t, L_t, b_t,
                                     **settings)
    assert X_j[0].dtype == jnp.float32 and X_t[0].dtype == F32
    assert abs(float(J.tt_inner_prod(X_j, Z_j))) < 1e-3
    slack, feas, dfeas = solve_metrics(X_t, Y_t, Z_t, obj_t, L_t, b_t)
    assert slack < 1e-3 and feas < 1e-3 and dfeas < 1e-3
    assert abs(info_t["num_iters"] - info_j["num_iters"]) <= 1
    assert info_t["ranksX"] == info_j["ranksX"]
    assert info_t["ranksZ"] == info_j["ranksZ"]


def _cu_consts(name):
    import os
    import re

    from ttipm_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, name)) as fh:
        return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", fh.read())}


def test_f32_k1_and_k2_plans_fit_the_cuda_limits():
    """The f32 instances' plans are sized in 4-byte elements against the
    sources' limits: every K1 tile and every K2 plan fits kMaxDynamicSmem,
    K2's buffers hold the widest term, and the f32 plan holds what the f64
    plan had to tile (one value of l at operator rank 10,000 is refused in
    f64 and taken in f32; s = S = 100 at R = 36 needs no R tiles)."""
    k1, k2 = _cu_consts("schur_assemble.cu"), _cu_consts("kkt_matvec.cu")
    limit = k1["kMaxDynamicSmem"]
    assert limit == k2["kMaxDynamicSmem"] == K.SMEM_LIMIT
    for R in (1, 8, 16, 32, 36):
        for s in (1, 4, 9, 100, 1000, 5000):
            dims = ((R, s, R, 4, 4, s, R, R),)
            tm, sc, _ = K.k1_tiles(dims, 4)
            assert tm in (16, 32, 64) and 1 <= sc <= s
            assert 4 * (tm * (sc | 1) + k1["kKS"] * (k1["kTN"] + 1)) <= limit
            assert sc >= K.k1_tiles(dims, 8)[1]
            for nrows in (1, 3):
                lc, rt, threads, smem, cap1, cap2, *caps = K.k2_tiles(dims, nrows, 4)
                assert smem == 4 * (2 * lc * 4 * R + cap1 + cap2 + sum(caps)) <= limit
                assert cap1 >= s * 4 * lc * min(rt, R) and threads <= k2["kMaxThreads"]
    assert K.k2_tiles(((36, 100, 36, 4, 4, 100, 36, 36),), 3, 4)[1] == 36
    assert K.k2_tiles(((36, 100, 36, 4, 4, 100, 36, 36),), 3)[1] == 18
    with pytest.raises(K.KernelError):
        K.k2_tiles(((1, 10000, 1, 4, 4, 1, 1, 1),), 1)
    assert K.k2_tiles(((1, 10000, 1, 4, 4, 1, 1, 1),), 1, 4)[0] == 1


def test_f32_k3_plan_fits_every_shape_of_the_envelope():
    """K3's f32 plan: the same CTAs, threads and workspace elements as the
    f64 plan (the slab height is set by registers), half the shared memory,
    within kMaxDynamicSmem; the whole envelope still needs the cluster
    regime (512 x 128 f32 is 256 KiB, more than one CTA's 227 KB)."""
    c = _cu_consts("panel_qr.cu")
    for n in range(1, K.K3_MAX_N + 1, 3):
        for m in range(n, K.K3_MAX_M + 1, 7):
            ctas, threads, ws, smem = K.k3_plan(m, n, 4)
            assert (ctas, threads, ws) == K.k3_plan(m, n)[:3]
            rows = -(-m // ctas)
            assert smem == 4 * ((rows | 1) * n + c["kScalarRows"] * n) <= c["kMaxDynamicSmem"]
            assert rows <= c["kMaxSlabRows"] and ctas <= c["kMaxCtas"]
    assert 4 * K.K3_MAX_M * K.K3_MAX_N > K.SMEM_LIMIT
    assert K.k3_plan(512, 128, 4)[:2] == (4, 1024)
