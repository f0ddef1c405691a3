"""The whole-solve path of the port against the JAX package's programs.

``config.set_fused_whole_solve(True)`` in both packages (restored to None,
auto, after each test): the fused AMEn solve as ``solve_program``, the
step-size eigensolve as ``gen_eigen_single`` and the smallest-eigenvector
solve as ``min_eig_program``, on the CPU, where ``solvers/graphs.py`` calls
each pair as it is (the plain version of the card's CUDA graphs).  Inputs
come from numpy seeds, as in tests/test_fused.py:174-360; the tolerances
are stated at each check.  Also plain-Python tests of ``graphs.py``: the
signature key, the shape rule that sends a signature to eager runs, and
the launch accounting of a replay.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ttipm_tpu import config as jconfig
from ttipm_tpu.ops import tt as J
from ttipm_tpu.ops.products import tt_fast_mat_mat_mul
from ttipm_tpu.ops.random import tt_random_gaussian
from ttipm_tpu.solvers import fused as JF
from ttipm_tpu.solvers.fused_eigen import tt_max_generalised_eigen_fused as eig_j
from ttipm_tpu.solvers.fused_eigen import tt_min_eig_fused as min_j
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.interop import tt_to_numpy, tt_to_torch
from ttipm_tpu_torch.ops import jacobi
from ttipm_tpu_torch.ops import kernels as K
from ttipm_tpu_torch.solvers import fused as TF
from ttipm_tpu_torch.solvers import fused_eigen as TE
from ttipm_tpu_torch.solvers import fused_eigen_batch as feb
from ttipm_tpu_torch.solvers import graphs
from ttipm_tpu_torch.solvers.fused_batch import batch_of_one

from test_fused import _make_kkt_system
from test_torch_fused import to_port


@pytest.fixture(autouse=True)
def _whole_solve():
    tconfig.set_rank_bucket(1)
    jconfig.set_fused_whole_solve(True)
    tconfig.set_fused_whole_solve(True)
    yield
    jconfig.set_fused_whole_solve(None)
    tconfig.set_fused_whole_solve(None)
    tconfig.set_rank_bucket(4)


def _dense(cores):
    """The full tensor of a train (the cores' gauge drops out)."""
    cores = [np.asarray(c) for c in tt_to_numpy(cores)]
    out = cores[0]
    for c in cores[1:]:
        out = np.tensordot(out, c, axes=([-1], [0]))
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_switch_semantics():
    tconfig.set_fused_whole_solve(None)
    assert tconfig.fused_whole_solve() is False  # auto: off, the port has no offload
    tconfig.set_fused_whole_solve(1)
    assert tconfig.fused_whole_solve() is True
    tconfig.set_fused_whole_solve(False)
    assert tconfig.fused_whole_solve() is False


# ---------------------------------------------------------------------------
# (a) the fused AMEn solve against JAX's _solve_program
# ---------------------------------------------------------------------------

@pytest.fixture
def kkt_d3():
    """The d3 KKT system of tests/test_fused.py::test_fused_device_loop_matches_host_loop."""
    np.random.seed(0)
    lhs, rhs = _make_kkt_system(3, np.random.RandomState(1))
    return (lhs, rhs) + to_port(lhs, rhs)


def _port_solve(lhs_t, rhs_t, term_tol, R, nswp, monkeypatch):
    """The port's solve and the pairs its program ran."""
    pairs = []
    run = graphs.run

    def counted(key, *a):
        pairs.append(key[0] == "fused_pair")
        return run(key, *a)

    monkeypatch.setattr(graphs, "run", counted)
    x, res = TF.tt_block_amen_fused(lhs_t, rhs_t, term_tol, R=R, nswp=nswp,
                                    rng=np.random.RandomState(3))
    return x, res, sum(pairs)


@pytest.mark.parametrize("R,term_tol,pairs", [(12, 1e-8, 0), (8, 1.35e-2, 2)])
def test_solve_program_matches_jax(kkt_d3, monkeypatch, R, term_tol, pairs):
    """R = 12: the peels reach the tolerance and no pair runs; R = 8 with a
    tolerance between the first and the second pair's residuals (1.43e-2,
    1.30e-2): the loop's test stops it after two of its four pairs."""
    lhs, rhs, lhs_t, rhs_t = kkt_d3
    x_t, res_t, pairs_t = _port_solve(lhs_t, rhs_t, term_tol, R, 12, monkeypatch)
    x_j, res_j = JF.tt_block_amen_fused(lhs, rhs, term_tol, R=R, ineq=False, nswp=12, seed=3)
    assert pairs_t == pairs
    # the solution: relative max difference of the full tensors 1e-6 (the
    # JAX device engine factors the Schur systems by QR, the port by LU)
    assert _rel(_dense(x_j), _dense(x_t)) < 1e-6
    # the final residual: 1e-4 relative, or both at the f64 noise floor
    if R == 12:
        assert res_t < 1e-9 and res_j < 1e-9
    else:
        assert res_t == pytest.approx(res_j, rel=1e-4)
    # the JAX program ran as many pairs: capped at that many (nswp = 4 + 2k)
    # it gives its own result, capped at one fewer it does not
    x_k, _ = JF.tt_block_amen_fused(lhs, rhs, term_tol, R=R, ineq=False, nswp=4 + 2 * pairs,
                                    seed=3)
    assert _rel(_dense(x_j), _dense(x_k)) < 1e-13
    if pairs:
        x_k1, _ = JF.tt_block_amen_fused(lhs, rhs, term_tol, R=R, ineq=False,
                                         nswp=2 + 2 * pairs, seed=3)
        assert _rel(_dense(x_j), _dense(x_k1)) > 1e-6


def test_short_solves_keep_the_sweep_loop(kkt_d3, monkeypatch):
    """nswp < 4: both packages keep their sweep loops (no program, no pair)."""
    lhs, rhs, lhs_t, rhs_t = kkt_d3
    x_t, res_t, pairs_t = _port_solve(lhs_t, rhs_t, 1e-8, 12, 3, monkeypatch)
    x_j, res_j = JF.tt_block_amen_fused(lhs, rhs, 1e-8, R=12, ineq=False, nswp=3, seed=3)
    assert pairs_t == 0
    assert _rel(_dense(x_j), _dense(x_t)) < 1e-10
    assert res_t == pytest.approx(res_j, rel=1e-8)


# ---------------------------------------------------------------------------
# (b)-(d) the eigen programs
# ---------------------------------------------------------------------------

def _pencil(d, seed):
    """tests/test_fused.py::test_whole_eigen_program_matches_host_loop's pencil."""
    np.random.seed(seed)
    B = tt_random_gaussian([2] * (d - 1), (2, 2))
    A = J.tt_add(tt_fast_mat_mat_mul(B, J.tt_transpose(B), 1e-12),
                 J.tt_scale(0.5, J.tt_identity(d)))
    np.random.seed(seed + 100)
    Dl = tt_random_gaussian([2] * (d - 1), (2, 2))
    D = J.tt_add(J.tt_add(J.tt_scale(0.5, Dl), J.tt_scale(0.5, J.tt_transpose(Dl))),
                 J.tt_scale(-0.3, J.tt_identity(d)))
    return A, D


def _port(train, dtype=torch.float64):
    return tt_to_torch(tt_to_numpy(train), device="cpu", dtype=dtype)


def _overlap(x_j, x_t):
    """|<x_j, x_t>| of two normalised trains (1: the same vector up to sign)."""
    a, b = _dense(x_j).ravel(), _dense(x_t).ravel()
    return abs(float(a @ b)) / (np.linalg.norm(a) * np.linalg.norm(b))


@pytest.mark.parametrize("d,seed", [(3, 0), (4, 1), (5, 2)])
def test_gen_eigen_program_matches_jax(d, seed):
    A, D = _pencil(d, seed)
    np.random.seed(7)
    s_j, x_j = eig_j(A, D, tol=1e-8)
    np.random.seed(7)
    s_t, x_t = TE.tt_max_generalised_eigen_fused(_port(A), _port(D), tol=1e-8)
    # the step: 1e-10 relative; the eigenvector: overlap 1 to 1e-10
    assert s_t == pytest.approx(s_j, rel=1e-10)
    assert 0.0 < s_t <= 1.0
    assert _overlap(x_j, x_t) == pytest.approx(1.0, abs=1e-10)


def test_gen_eigen_program_zero_step():
    """A on the PSD boundary along -Delta: a finite, non-negative, tiny step
    in both packages (tests/test_fused.py::test_whole_eigen_program_zero_step)."""
    A = J.tt_scale(1e-12, J.tt_identity(3))
    D = J.tt_scale(-1.0, J.tt_identity(3))
    np.random.seed(7)
    s_j, _ = eig_j(A, D, tol=1e-8)
    np.random.seed(7)
    s_t, x_t = TE.tt_max_generalised_eigen_fused(_port(A), _port(D), tol=1e-8)
    assert np.isfinite(s_t) and 0.0 <= s_t <= 1.1e-11
    # 1e-10 relative
    assert s_t == pytest.approx(s_j, rel=1e-10)
    assert all(bool(torch.isfinite(c).all()) for c in x_t)


def test_gen_eigen_program_f32_native():
    """The f32 profile with native f32 pencils in both packages
    (tests/test_fused.py::test_whole_eigen_program_f32_native's pencil)."""
    d = 4
    np.random.seed(11)
    B = tt_random_gaussian([2] * (d - 1), (2, 2))
    A = J.tt_add(tt_fast_mat_mat_mul(B, J.tt_transpose(B), 1e-12),
                 J.tt_scale(0.5, J.tt_identity(d)))
    np.random.seed(111)
    Dl = tt_random_gaussian([2] * (d - 1), (2, 2))
    D = J.tt_add(J.tt_add(J.tt_scale(0.5, Dl), J.tt_scale(0.5, J.tt_transpose(Dl))),
                 J.tt_scale(-0.3, J.tt_identity(d)))
    np.random.seed(7)
    s_f64, _ = TE.tt_max_generalised_eigen_fused(_port(A), _port(D), tol=1e-8)
    jconfig.set_dtype(jnp.float32)
    jconfig.set_eigen_dtype("native")
    tconfig.set_dtype(torch.float32)
    tconfig.set_eigen_dtype("native")
    try:
        np.random.seed(7)
        s_j, _ = eig_j([jnp.asarray(c, dtype=jnp.float32) for c in A],
                       [jnp.asarray(c, dtype=jnp.float32) for c in D], tol=1e-8)
        np.random.seed(7)
        s_t, x_t = TE.tt_max_generalised_eigen_fused(_port(A, torch.float32),
                                                     _port(D, torch.float32), tol=1e-8)
    finally:
        jconfig.set_eigen_dtype("f64")
        jconfig.set_dtype(jnp.float64)
        tconfig.set_eigen_dtype("f64")
        tconfig.set_dtype(torch.float64)
    assert x_t[0].dtype == torch.float32
    # f32 pencils: 1e-5 relative to the JAX package's f32 step, and the
    # 3-digit agreement with f64 of the JAX test (5e-3)
    assert s_t == pytest.approx(s_j, rel=1e-5)
    assert abs(s_t - s_f64) < 5e-3 * max(abs(s_f64), 1.0)


@pytest.mark.parametrize("d,seed", [(3, 0), (5, 2)])
def test_min_eig_program_matches_jax(d, seed):
    A, _ = _pencil(d, seed)
    np.random.seed(7)
    x_j, v_j = min_j(A, return_eig_val=True)
    np.random.seed(7)
    x_t, v_t = TE.tt_min_eig_fused(_port(A), return_eig_val=True)
    M = np.asarray(J.tt_matrix_to_matrix(A))
    lam = np.linalg.eigvalsh(0.5 * (M + M.T))[0]
    # the eigenvalue: 1e-10 relative to JAX's, 1e-4 to the dense one (the
    # JAX test's bound); the eigenvector: overlap 1 to 1e-8
    assert float(v_t) == pytest.approx(float(v_j), rel=1e-10)
    assert float(v_t) == pytest.approx(lam, rel=1e-4, abs=1e-7)
    assert _overlap(x_j, x_t) == pytest.approx(1.0, abs=1e-8)


@pytest.mark.parametrize("d,seed", [(3, 0), (5, 2)])
def test_single_program_is_the_batch_programs_instance(d, seed):
    """gen_eigen_single (host decisions as selects) and gen_eigen_program
    (branching) on the same batch of one: the same bits on the CPU."""
    A, D = _pencil(d, seed)
    A_p = TE._prep_operator(_port(A))
    D_p = TE._prep_operator(_port(D))
    caps = TE._vec_caps(d, 8, 2)
    xs = TE._prep_vec(None, d, 2, caps, np.random.RandomState(7), A_p[0])
    args = (batch_of_one(A_p), batch_of_one(D_p), batch_of_one(xs),
            torch.ones(1, dtype=torch.float64), 1e-8, caps, 9)
    single = feb.gen_eigen_single(*args)
    batch = feb.gen_eigen_program(*args)
    assert all(torch.equal(a, b) for a, b in zip(single[0], batch[0]))
    for a, b in zip(single[1:], batch[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (f) graphs.py in plain Python
# ---------------------------------------------------------------------------

def test_signature_key():
    def t(*shape, dtype=torch.float64):
        return torch.zeros(*shape, dtype=dtype)

    tree = ({"a": [t(2, 3), t(3)]}, [t(1, 4)], 5)
    same = ({"a": [t(2, 3), t(3)]}, [t(1, 4)], 5)
    assert graphs.signature("k", tree) == graphs.signature("k", same)
    assert graphs.signature("k", tree) != graphs.signature("other", same)
    for changed in (({"a": [t(2, 4), t(3)]}, [t(1, 4)], 5),                      # a shape
                    ({"a": [t(2, 3), t(3, dtype=torch.float32)]}, [t(1, 4)], 5),  # a dtype
                    ({"b": [t(2, 3), t(3)]}, [t(1, 4)], 5),                      # a key
                    ({"a": [t(2, 3), t(3)]}, [t(1, 4), t(1)], 5),                # a leaf more
                    ({"a": [t(2, 3), t(3)]}, [t(1, 4)], 6)):                     # a constant
        assert graphs.signature("k", tree) != graphs.signature("k", changed)
    # the settings that change a body at equal shapes
    base = graphs.signature("k", tree)
    tconfig.set_mixed_local("refine")
    try:
        assert graphs.signature("k", same) != base
    finally:
        tconfig.set_mixed_local("f64")
    leaves, spec = graphs.flatten(tree)
    assert len(leaves) == 3
    back = graphs.unflatten(spec, leaves)
    assert back[0]["a"][0] is leaves[0] and back[1][0] is leaves[2] and back[2] == 5


def test_shape_rule_sends_signatures_outside_the_envelopes_to_eager_runs():
    """A pair whose factorizations stay inside the kernels' envelopes is
    captured; one that sends any factorization to torch.linalg by the
    Jacobi pipelines' shape rule runs eagerly."""
    rng = np.random.RandomState(0)

    def sym(n):
        a = torch.as_tensor(rng.randn(n, n))
        return a + a.T

    with jacobi.forced(True):
        before = K.counts_snapshot()
        jacobi.jacobi_eigh(sym(8)[None])                       # J2's plain version
        jacobi.jacobi_svd(torch.as_tensor(rng.randn(1, 40, 12)))
        assert not graphs.sends_eager(K.counts_delta(before, K.counts_snapshot()))
        jacobi.jacobi_eigh(sym(K.J2_MAX_N + 2)[None])          # outside: torch.linalg.eigh
        assert graphs.sends_eager(K.counts_delta(before, K.counts_snapshot()))
        before = K.counts_snapshot()
        jacobi.jacobi_svd(torch.as_tensor(rng.randn(1, 140, K.J1_MAX_N + 2)))
        assert graphs.sends_eager(K.counts_delta(before, K.counts_snapshot()))


def test_replays_add_the_captured_launches():
    """A capture's counts come out of kernels.STATS (nothing ran) and every
    replay adds them again."""
    K.reset_counts()
    K.STATS["panel_qr"].count("f64")
    start = K.counts_snapshot()
    # every counter KernelStats.reset sets is in the snapshot
    assert set(start["panel_qr"]) == set(vars(K.STATS["panel_qr"])) - {"name"}
    # what a capture counts: two K2 launches (one grouped), a batched K4, a J2
    K.STATS["kkt_block_matvec"].count("f64", grouped=True)
    K.STATS["kkt_block_matvec"].count("f32")
    K.STATS["panel_cholesky"].count("f64", batch=3)
    K.STATS["jacobi_eigh"].count("f64", batch=1)
    K.STATS["jacobi_eigh"].by_regime["block"] += 1
    captured = K.counts_delta(start, K.counts_snapshot())
    K.add_counts(captured, -1)
    assert K.counts_snapshot() == start
    K.add_counts(captured, 3)  # three replays
    s = K.STATS
    assert s["kkt_block_matvec"].launches == 6 and s["kkt_block_matvec"].grouped == 3
    assert s["kkt_block_matvec"].by_dtype == {"f64": 3, "f32": 3}
    assert s["panel_cholesky"].launches == 3 and s["panel_cholesky"].instances == 9
    assert s["jacobi_eigh"].by_regime == {"element": 0, "block": 3}
    assert s["panel_qr"].launches == 1
    K.reset_counts()


def test_run_calls_the_body_as_it_is_on_the_cpu():
    graphs.reset()
    args = ([torch.ones(2)], {"k": torch.zeros(3)})
    out = graphs.run(("step",), lambda a: (a[0][0] + 1, a[1]["k"]), args)
    assert torch.equal(out[0], torch.full((2,), 2.0))
    assert out[1] is args[1]["k"]  # no staging on the CPU: the plain version's bits
    assert graphs.STATS.as_dict() == {"captures": 0, "replays": 0, "eager_signatures": 0,
                                      "eager_steps": 0, "forced_steps": 0, "by_step": {}}
