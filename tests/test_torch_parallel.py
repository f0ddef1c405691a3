"""Parity of the port's batched seeds (``ttipm_tpu_torch.parallel``) with
the JAX package's ``ttipm_tpu.parallel`` on the CPU, at d3 / d4.

* The padded prep (``prep_operator`` / ``prep_rhs`` with ``pad=True``)
  gives the JAX package's shapes and values exactly (zero padding).
* ``tt_block_amen_fused_batch`` on four synthetic systems at R = 16 (the
  full structural bond width at d3, so each solve is exact up to
  conditioning): every instance's relative residual below 1e-6, the JAX
  test's bound, and the dense solutions equal to the JAX package's batched
  solve to 1e-8 relative.  The two engines differ (the port factors the
  Schur systems by LU, the JAX batch's device engine by QR), so they agree
  to the rounding of two backward-stable solves of a system solved to a
  residual of 1e-11, not to the bit.
* ``tt_step_sizes_batch`` against the JAX package's and the port's single
  ``tt_max_generalised_eigen_fused``: 2e-6 relative, the JAX test's bound
  for the batch against the single solve.
* ``tt_newton_step_batch``: an instance's steps do not depend on the batch
  it rides in (1e-5, the JAX test's bound), and a full IPM iteration on two
  maxcut d3 instances gives the JAX package's steps (1e-5) and next
  iterates (1e-4 relative, the JAX test's bounds for its mesh against its
  single device).
* The plain batched kernels (what a CPU tensor runs) against their
  per-instance plain calls, to ``checks``' tolerances.
* ``run_batch`` on the CPU with two workers gives the JAX package's
  iterations and ``ok`` per seed.
"""

import os

import numpy as np
import pytest
import torch

from ttipm_tpu import config as jconfig
from ttipm_tpu.parallel import fused_mesh as JM
from ttipm_tpu.solvers import fused as JF
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.checks import check_kernel, first_newton_system
from ttipm_tpu_torch.interop import (
    block_matrix_to_torch, block_vector_to_torch, tt_to_numpy, tt_to_torch)
from ttipm_tpu_torch.ops import kernels as K
from ttipm_tpu_torch.ops import tt as TT
from ttipm_tpu_torch.parallel import fused_mesh as TM
from ttipm_tpu_torch.solvers import fused as TF
from ttipm_tpu_torch.utils.runner import load_yaml


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def to_port(lhs, rhs):
    return (block_matrix_to_torch({k: [np.asarray(c) for c in v] for k, v in lhs._data.items()},
                                  lhs._aliases, lhs._transposes, device="cpu"),
            block_vector_to_torch({i: [np.asarray(c) for c in v] for i, v in rhs.items()},
                                  device="cpu"))


def _systems(ineq, n=4, d=3):
    from test_fused import _make_ineq_kkt_system, _make_kkt_system

    rng = np.random.RandomState(4)
    make = _make_ineq_kkt_system if ineq else _make_kkt_system
    return [make(d, rng) for _ in range(n)]


def _dense(x):
    full = np.asarray(x[0])
    for c in x[1:]:
        full = np.tensordot(full, np.asarray(c), axes=([-1], [0]))
    return full


@pytest.mark.parametrize("ineq", [False, True], ids=["eq", "ineq"])
def test_padded_prep_matches_jax(ineq):
    d = 3
    lhs, rhs = _systems(ineq, n=1)[0]
    lhs_t, rhs_t = to_port(lhs, rhs)
    A_j = JF._prep_operator(lhs, d, ineq, pad=True)
    b_j = JF._prep_rhs(rhs, d, ineq, pad=True)
    A_t = TF.prep_operator(lhs_t, ineq, pad=True)
    b_t = TF.prep_rhs(rhs_t, d, rhs_t.get_row(0)[0], ineq, pad=True)
    assert set(A_t) == set(A_j)
    for key in A_j:
        for cj, ct in zip(A_j[key], A_t[key]):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert [c.shape[-1] for c in A_t["12"][:-1]] == [1] * (d - 1)
    for rj, rt in zip(b_j, b_t):
        for cj, ct in zip(rj, rt):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("ineq", [False, True], ids=["eq", "ineq"])
def test_fused_batch_matches_jax(ineq):
    d = 3
    systems = _systems(ineq)
    kw = dict(R=16, ineq=ineq, term_tol=1e-10, nswp=14, seed=7)
    x_j, res_j = JM.tt_block_amen_fused_batch([s[0] for s in systems],
                                              [s[1] for s in systems], mesh=None, **kw)
    port = [to_port(*s) for s in systems]
    x_t, res_t = TM.tt_block_amen_fused_batch([p[0] for p in port], [p[1] for p in port], **kw)
    assert res_t.shape == (4,) and np.isfinite(res_t).all()
    for (lhs_t, rhs_t), xj, xt in zip(port, x_j, x_t):
        A = TF.prep_operator(lhs_t, ineq)
        b = TF.prep_rhs(rhs_t, d, xt[0], ineq)
        assert TF.fused_residual_norm(A, b, list(xt), ineq) / rhs_t.norm < 1e-6
        dj, dt = _dense(xj), _dense(tt_to_numpy(xt))
        assert np.abs(dt - dj).max() <= 1e-8 * np.abs(dj).max()


def test_fused_batch_structural_mismatch_raises():
    from ttipm_tpu.ops.tt import tt_add

    systems = _systems(False, n=2)
    lhs, rhs = systems[1]
    lhs[0, 0] = tt_add(lhs[0, 0], tt_add(lhs[0, 0], lhs[0, 0]))  # a larger bucketed rank
    port = [to_port(*s) for s in systems]
    with pytest.raises(ValueError, match="structurally identical"):
        TM.tt_block_amen_fused_batch([p[0] for p in port], [p[1] for p in port], R=8,
                                     ineq=False, nswp=2)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TM.tt_block_amen_fused_batch([p[0] for p in port], [p[1] for p in port], R=8,
                                     ineq=False, mesh=object())


def _pencils():
    """The four pencils of tests/test_parallel.py's step-size test."""
    from ttipm_tpu.ops.products import tt_fast_mat_mat_mul
    from ttipm_tpu.ops.random import tt_random_gaussian
    from ttipm_tpu.ops.tt import tt_add, tt_identity, tt_scale, tt_transpose

    jconfig.set_rank_bucket(1)
    pencils = []
    for seed in (0, 1, 2, 3):
        d = 4
        np.random.seed(seed)
        B = tt_random_gaussian([2] * (d - 1), (2, 2))
        A_tt = tt_add(tt_fast_mat_mat_mul(B, tt_transpose(B), 1e-12),
                      tt_scale(0.5, tt_identity(d)))
        np.random.seed(seed + 50)
        Dl = tt_random_gaussian([2] * (d - 1), (2, 2))
        D_tt = tt_add(tt_add(tt_scale(0.5, Dl), tt_scale(0.5, tt_transpose(Dl))),
                      tt_scale(-0.3, tt_identity(d)))
        pencils.append((A_tt, D_tt))
    return pencils


def test_step_sizes_batch_matches_jax_and_single():
    from ttipm_tpu_torch.solvers.fused_eigen import tt_max_generalised_eigen_fused

    pencils = _pencils()
    np.random.seed(7)
    steps_j, _ = JM.tt_step_sizes_batch(pencils, mesh=None)
    port = [(tt_to_torch(a, device="cpu"), tt_to_torch(b, device="cpu")) for a, b in pencils]
    np.random.seed(7)
    steps_t, warm = TM.tt_step_sizes_batch(port)
    for i, (A_t, D_t) in enumerate(port):
        np.random.seed(7)
        single, _ = tt_max_generalised_eigen_fused(A_t, D_t, tol=1e-8)
        assert abs(steps_t[i] - single) <= 2e-6 * max(1.0, abs(single))
        assert abs(steps_t[i] - steps_j[i]) <= 2e-6 * max(1.0, abs(steps_j[i]))
    assert all(bool(torch.isfinite(c).all()) for w in warm for c in w)


def test_newton_step_batch_independence():
    """An instance's steps do not depend on the batch it rides in; the steps
    are cone steps and the directions finite (tests/test_parallel.py:146)."""
    from test_fused import _make_kkt_system

    d = 3
    systems, Xs, Zs = [], [], []
    for seed in (11, 12, 13):
        systems.append(to_port(*_make_kkt_system(d, np.random.RandomState(seed))))
        Xs.append(TT.tt_scale(1.0 + 0.1 * seed, TT.tt_identity(d, device="cpu")))
        Zs.append(TT.tt_scale(2.0, TT.tt_identity(d, device="cpu")))
    xs3, zs3, dirs3 = TM.tt_newton_step_batch(systems, Xs, Zs, R=12, seed=5)
    xs1, zs1, _ = TM.tt_newton_step_batch(systems[:1], Xs[:1], Zs[:1], R=12, seed=5)
    assert abs(xs3[0] - xs1[0]) < 1e-5 * max(1.0, abs(xs1[0]))
    assert abs(zs3[0] - zs1[0]) < 1e-5 * max(1.0, abs(zs1[0]))
    assert all(bool(torch.isfinite(c).all()) for ds in dirs3 for t in ds for c in t)
    assert np.all(xs3 > 0) and np.all(xs3 <= 1.0)
    assert np.all(zs3 > 0) and np.all(zs3 <= 1.0)


def test_batch_drivers_return_fresh_contiguous_instances():
    """The batched solve's per-instance cores and the batched step sizes'
    eigenvector trains are fresh contiguous allocations (storage offset 0),
    whatever the batch's strides.  On the card cuBLAS takes another kernel
    for a transposed operand or another alignment of the same values, so a
    view of the batch (transposed strides after a backward sweep, an
    instance's offset) made the warm starts' retraction of a seeds mesh's
    shard compute other bits than ``mesh=None``'s (phase 11 of
    chip_smoke.py; a 4 x 4 ``mm`` in ``_svd_retract``)."""
    from ttipm_tpu_torch.tools.scaling_bench import make_instances

    systems, Xs, Zs, _ = make_instances(3, 2, torch.device("cpu"))
    sols, _ = TM.tt_block_amen_fused_batch([s[0] for s in systems], [s[1] for s in systems],
                                           R=12, ineq=False, seed=1)
    _, warm = TM.tt_step_sizes_batch([(Xs[i], Zs[i]) for i in range(2)], R=8)
    for train in sols + warm:
        for c in train:
            assert c.is_contiguous() and c.storage_offset() == 0, (tuple(c.stride()),
                                                                   c.storage_offset())


def test_newton_step_batch_full_iteration_matches_jax():
    """A full IPM iteration (tests/test_parallel.py:177-268): the real KKT
    assembly and equilibration of two maxcut d3 instances in each package
    (the port's captured from its ``ipm.tt_ipm`` at configs/maxcut_3.yaml's
    settings by ``checks.first_newton_system``), the batched Newton step in both,
    the PSD-rounded next iterates."""
    from ttipm_tpu.ipm import (IPMStatus, IneqStatus, _tt_build_row_scaled_kkt,
                               tt_infeasible_newton_system)
    from ttipm_tpu.models.maxcut import create_problem
    from ttipm_tpu.ops import tt as J
    from ttipm_tpu.ops.rounding import tt_psd_rank_reduce
    from ttipm_tpu.solvers.blocks import TTBlockMatrix
    from ttipm_tpu_torch.ops.rounding import tt_psd_rank_reduce as psd_t

    jconfig.set_rank_bucket(1)
    d = 3
    instances = []
    for seed in (319, 7):
        np.random.seed(seed)
        obj, L, bias, lag_y = create_problem(d, 1)
        obj, bias, lag_y = J.tt_reshape(obj, (4,)), J.tt_reshape(bias, (4,)), J.tt_reshape(
            lag_y, (4, 4))
        status = IPMStatus(d, 2 * 3e-4, 3e-4 / np.sqrt(d), 1e-4, 1e-12, False, False, np.inf,
                           False, np.inf, False, np.inf, np.inf, False, IneqStatus.NOT_IN_USE,
                           False, 1, 1, 2 * d)
        status.primal_error_normalisation = 1 + J.tt_norm(bias)
        status.dual_error_normalisation = 1 + J.tt_norm(obj)
        lhs = TTBlockMatrix()
        lhs[1, 2] = J.tt_reshape(J.tt_identity(2 * d), (4, 4))
        lhs[0, 1] = J.tt_scale(-1, L)
        lhs.add_alias((0, 1), (1, 0), is_transpose=True)
        lhs[0, 0] = lag_y
        X, Z = J.tt_identity(d), J.tt_identity(d)
        Y = J.tt_reshape(J.tt_zero_matrix(d), (4,))
        lhs, rhs, status = tt_infeasible_newton_system(lhs, obj, X, Y, Z, None, L,
                                                       J.tt_transpose(L), bias, None, status)
        lhs_s, rhs_s = _tt_build_row_scaled_kkt(lhs, rhs, status)
        instances.append((lhs_s, rhs_s, X, Z, status.eta))

    xs_j, zs_j, dirs_j = JM.tt_newton_step_batch([i[:2] for i in instances],
                                                 [i[2] for i in instances],
                                                 [i[3] for i in instances], mesh=None, R=12,
                                                 seed=5)
    # the port assembles its own systems of the same instances
    cfg = load_yaml(os.path.join(os.path.dirname(__file__), "..", "configs", "maxcut_3.yaml"))
    built = [first_newton_system("maxcut", cfg, seed, "cpu") for seed in (319, 7)]
    for (_, rhs_j, *_), (_, rhs_t, *_) in zip(instances, built):
        assert rhs_t.norm == pytest.approx(rhs_j.norm, rel=1e-12)
    Xs, Zs = [b[2] for b in built], [b[3] for b in built]
    xs_t, zs_t, dirs_t = TM.tt_newton_step_batch([b[:2] for b in built], Xs, Zs, R=12, seed=5)
    for i, (*_, eta) in enumerate(instances):
        assert abs(xs_t[i] - xs_j[i]) < 1e-5 * max(1.0, abs(xs_j[i]))
        assert abs(zs_t[i] - zs_j[i]) < 1e-5 * max(1.0, abs(zs_j[i]))
        for base, step, which in ((Xs[i], xs_t[i], 1), (Zs[i], zs_t[i], 2)):
            nxt_t = psd_t(TT.tt_add(base, TT.tt_scale(float(step), dirs_t[i][which])), eps=eta)
            base_j = instances[i][2 if which == 1 else 3]
            step_j = xs_j[i] if which == 1 else zs_j[i]
            nxt_j = tt_psd_rank_reduce(J.tt_add(base_j, J.tt_scale(float(step_j),
                                                                    dirs_j[i][which])), eps=eta)
            nxt_j = tt_to_torch(nxt_j, device="cpu")
            assert TT.tt_l2_dist(nxt_t, nxt_j) / max(TT.tt_norm(nxt_j), 1e-12) < 1e-4
        nxt_x = psd_t(TT.tt_add(Xs[i], TT.tt_scale(float(xs_t[i]), dirs_t[i][1])), eps=eta)
        nxt_z = psd_t(TT.tt_add(Zs[i], TT.tt_scale(float(zs_t[i]), dirs_t[i][2])), eps=eta)
        assert abs(TT.tt_inner_prod(nxt_x, nxt_z)) < abs(TT.tt_inner_prod(Xs[i], Zs[i]))


def test_plain_batched_kernels_match_per_instance():
    """The batched entries on CPU tensors run their plain versions: each
    instance within ``checks``' tolerances of the single entry's plain
    version on it, one plain call a batch."""
    rng = np.random.RandomState(3)
    B = 3

    def t(*shape):
        return torch.as_tensor(rng.randn(B, *shape))

    x = t(6, 3, 4, 5)
    ops = [(t(7, s, 6), t(s, 4, 4, S), t(8, S, 5)) for s, S in ((2, 3), (1, 1), (4, 2))]
    flipped = (t(6, 2, 7).permute(0, 3, 2, 1), t(2, 4, 4, 3).transpose(2, 3),
               t(5, 3, 8).permute(0, 3, 2, 1))
    terms = [(*ops[0], x[:, :, 0], 0), (*flipped, x[:, :, 1], 0), (*ops[1], x[:, :, 2], 2)]
    blocks = [ops[0], flipped, ops[2]]
    panels = t(40, 10)
    spd = panels.mT @ panels + torch.eye(10, dtype=panels.dtype)
    spd[1, 4, 4] = -1.0
    K.reset_counts()
    y = K.kkt_block_product_batch(terms, 3)
    G = K.schur_assemble_batch(blocks)
    q, r = K.panel_qr_batch(panels, transposed=True)
    L, info = K.panel_cholesky_batch(spd)
    sym = spd[:, :8, :8]
    wr, v, norms2 = K.jacobi_orthogonalise(panels[:, :10, :].contiguous())
    ev, ew = K.jacobi_eigh_core(sym)
    assert [K.STATS[n].plain_calls for n in K.STATS] == [1, 1, 1, 1, 1, 1]
    assert sum(s.launches for s in K.STATS.values()) == 0
    for i in range(B):
        one = lambda group: [tuple(v[i] if torch.is_tensor(v) else v for v in g) for g in group]
        check_kernel("kkt_block_product", (one(terms), 3), y[i])
        check_kernel("schur_assemble_group", (one(blocks),), list(G[:, i]))
        check_kernel("panel_qr", (panels[i],), (q[i].T, r[i]))
        check_kernel("panel_cholesky", (spd[i],), (L[i], info[i]))
        check_kernel("jacobi_orthogonalise", (panels[i:i + 1, :10],),
                     (wr[i:i + 1], v[i:i + 1], norms2[i:i + 1]))
        check_kernel("jacobi_eigh_core", (sym[i:i + 1],), (ev[i:i + 1], ew[i:i + 1]))
    assert info.tolist() == [0, 5, 0]
    with pytest.raises(K.KernelError, match="batch"):
        K.panel_qr_batch(panels[0])


def test_batch_errors_report_cholesky_info():
    """``checks.batch_errors`` of a batched Cholesky: ``info`` the first
    instance's nonzero info (0 when every instance factors), ``infos`` all
    of them, and ``ok`` where each instance agrees with its plain version."""
    from ttipm_tpu_torch.checks import batch_errors

    rng = np.random.RandomState(5)
    panels = torch.as_tensor(rng.randn(3, 30, 8))
    spd = panels.mT @ panels + torch.eye(8, dtype=panels.dtype)
    errs = batch_errors("panel_cholesky_batch", (spd,), K.panel_cholesky_batch(spd))
    assert (errs["ok"], errs["info"], errs["infos"], errs["instances"]) == (True, 0, [0, 0, 0], 3)
    spd[2, 3, 3] = -1.0
    errs = batch_errors("panel_cholesky_batch", (spd,), K.panel_cholesky_batch(spd))
    assert (errs["ok"], errs["info"], errs["infos"]) == (True, 4, [0, 0, 4])


def test_run_batch_matches_jax():
    from ttipm_tpu.parallel.batch import run_batch as run_j
    from ttipm_tpu_torch.parallel.batch import run_batch as run_t

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                          "maxcut_3.yaml")
    seeds = [1015, 319]  # the config's seed, and one more for the second worker
    got = {r["seed"]: r for r in run_t("maxcut", config, seeds, workers=2, device="cpu")}
    want = {r["seed"]: r for r in run_j("maxcut", config, seeds, workers=2, platform="cpu")}
    assert set(got) == set(want) == set(seeds)
    for s in seeds:
        assert got[s]["ok"] and want[s]["ok"], (got[s], want[s])
        assert got[s]["num_iters"] == want[s]["num_iters"]
        assert got[s]["slackness"] == pytest.approx(want[s]["slackness"], rel=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_t("maxcut", config, seeds, device="cuda")


def test_kkt_residual_norm_resolves_what_the_expansion_cannot():
    """``checks.kkt_residual_norm`` (the exact residual train,
    RL-orthogonalised) against the residual of the ALS block product, on
    a solve accurate far below the ~1.5e-8 where the solver's residual
    expansion cancels: the two agree to 1e-3 relative."""
    from ttipm_tpu_torch.checks import kkt_residual_norm

    d = 3
    lhs_t, rhs_t = to_port(*_systems(False, n=1)[0])
    x, _ = TF.tt_block_amen_fused(lhs_t, rhs_t, 1e-12, R=16, nswp=14,
                                  rng=np.random.RandomState(7))
    A, b = TF.prep_operator(lhs_t), TF.prep_rhs(rhs_t, d, x[0])
    exact = kkt_residual_norm(A, b, x)
    als = (rhs_t - lhs_t.block_product(x, 1e-14, eps=1e-16)).norm
    assert 0 < exact < 1e-9 * rhs_t.norm
    assert exact == pytest.approx(als, rel=1e-3)
