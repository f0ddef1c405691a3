"""Parity of the port's graphm model and of the rest of ``ops/tt.py`` with
the JAX package, on the CPU at rank bucket 1, from the same numpy inputs.

* The functions of ``ops/tt.py`` graphm brought in (``tt_sum`` with and
  without rounding, the triangular all-ones matrices at dims 1-4) and the
  rest of the module (``tt_kron``, ``tt_entry``, ``tt_l2_dist``,
  ``tt_copy``, ``tt_swap_all``) on the cases of tests/test_tt_ops.py: equal
  ranks and shapes, dense values to 1e-12 relative.
* ``create_problem`` at n=2 and n=3, seeds 256 and 493: C, L, the bias, the
  mask and both Lagrange maps have the JAX package's TT ranks and core
  shapes; at n=2 they are equal as dense arrays (L is 1024 x 1024) to 1e-12
  relative; at n=3 (L is 16384 x 16384) by the distance of the two trains
  to 1e-12 relative.  That distance is the norm of the difference train
  after a right-to-left orthogonalisation, which is ``tt_l2_dist`` without
  its rank-additive inner-product expansion: the expansion cancels to
  ~sqrt(eps) of the norm (tests/test_checkpoint.py says the same).  No
  ``tt_rank_reduce`` at 1e-12 in the generator has a singular value near
  its cut: the ranks come out alike with both SVDs.
* The first Newton system of graphm n=2 seed 256 at the settings of
  configs/graphm_2.yaml: each package's ``tt_infeasible_newton_system``
  builds it at the same initial point (the same blocks, aliases and right
  side, dense, to 1e-10 relative).  The port's ragged AMEn with
  ``ipm_local_solver_ineq`` then solves it on the CPU; its relative
  residual, computed densely from the JAX package's blocks, is below the
  solver's termination tolerance (the IPM's eta, 1e-3, at that point).
* ``slow``: graphm n=2 seed 256 solved by both packages, at the config's
  settings and at those of the JAX package's graphm test (see
  ``test_graphm_n2_matches_jax``).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ttipm_tpu.ipm as jipm
import ttipm_tpu.ops.tt as J
import ttipm_tpu_torch.ipm as tipm
import ttipm_tpu_torch.ops.tt as T
from ttipm_tpu import config as jconfig
from ttipm_tpu.models import graphm as JG
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.interop import block_matrix_to_torch, block_vector_to_torch, tt_to_torch
from ttipm_tpu_torch.models import graphm as TG
from ttipm_tpu_torch.ops.rounding import tt_rl_orthogonalise
from ttipm_tpu_torch.solvers import local_kkt as TK
from ttipm_tpu_torch.solvers.amen import tt_restarted_block_amen
from ttipm_tpu_torch.solvers.blocks import tt_get_block
from ttipm_tpu_torch.utils.runner import load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


@pytest.fixture(autouse=True)
def _bucket1():
    tconfig.set_rank_bucket(1)
    yield
    tconfig.set_rank_bucket(4)


def config_settings():
    """The IPM settings of configs/graphm_2.yaml, as the runner passes them."""
    c = load_yaml(os.path.join(REPO, "configs", "graphm_2.yaml"))
    return dict(max_iter=c["max_iter"], gap_tol=float(c["gap_tol"]),
                op_tol=float(c["op_tol"]), abs_tol=float(c["abs_tol"]), warm_up=c["warm_up"],
                aho_direction=False, mals_restarts=c["mals_restarts"],
                max_refinement=c["max_refinement"], lambdaStar=float(c["lambdaStar"]),
                lambdaStarIneq=float(c["lambdaStarIneq"]))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def port(train):
    return tt_to_torch([np.asarray(c) for c in train], device="cpu")


def np_train(rng, d, rank, phys):
    ranks = [1] + [rank] * (d - 1) + [1]
    return [rng.standard_normal((ranks[k],) + tuple(phys) + (ranks[k + 1],))
            for k in range(d)]


def same_train(t_port, t_jax, dense=True, tol=TOL):
    """Equal core shapes (so equal ranks) and equal values: dense, or by
    the stable distance of the two trains."""
    assert [tuple(c.shape) for c in t_port] == [tuple(np.shape(c)) for c in t_jax]
    if dense:
        got = T.tt_to_tensor(t_port).numpy()
        want = np.asarray(J.tt_to_tensor(t_jax))
        assert rel(got, want) <= tol
    else:
        want = port(t_jax)
        diff = tt_rl_orthogonalise(T.tt_sub(t_port, want))
        dist = float(torch.linalg.norm(diff[0]))
        assert dist <= tol * T.tt_norm(want), dist / T.tt_norm(want)


# --- the rest of ops/tt.py ----------------------------------------------------

@pytest.mark.parametrize("kind", ["tril", "triu"])
@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_triangular_one_matrices_match_jax(kind, dim):
    fj, ft = {"tril": (J.tt_tril_one_matrix, T.tt_tril_one_matrix),
              "triu": (J.tt_triu_one_matrix, T.tt_triu_one_matrix)}[kind]
    got = ft(dim, device="cpu")
    assert all(c.dtype == torch.float64 for c in got)
    same_train(got, fj(dim), tol=0.0)
    n = 2**dim
    want = np.tril(np.ones((n, n))) if kind == "tril" else np.triu(np.ones((n, n)))
    np.testing.assert_array_equal(T.tt_matrix_to_matrix(got).numpy(), want)


@pytest.mark.parametrize("rank_reduce", [True, False])
def test_sum_matches_jax(rank_reduce):
    rng = np.random.RandomState(5)
    trains = [np_train(rng, 4, r, (2, 2)) for r in (3, 2, 3)]
    # the third is the first scaled: the rounded sum loses its ranks
    trains[2] = [-0.5 * trains[0][0]] + trains[0][1:]
    got = T.tt_sum(*[port(t) for t in trains], rank_reduce=rank_reduce)
    want = J.tt_sum(*[[jnp.asarray(c) for c in t] for t in trains], rank_reduce=rank_reduce)
    assert T.tt_ranks(got) == J.tt_ranks(want)
    assert T.tt_ranks(got) == ([4, 5, 4] if rank_reduce else [8, 8, 8])
    assert rel(T.tt_matrix_to_matrix(got).numpy(), J.tt_matrix_to_matrix(want)) <= TOL


def test_kron_matches_jax():
    rng = np.random.RandomState(6)
    a, b = np_train(rng, 3, 2, (2, 2)), np_train(rng, 3, 3, (2, 2))
    got = T.tt_kron(port(a), port(b))
    want = J.tt_kron([jnp.asarray(c) for c in a], [jnp.asarray(c) for c in b])
    assert [tuple(c.shape) for c in got] == [tuple(c.shape) for c in want]
    assert rel(T.tt_matrix_to_matrix(got).numpy(), J.tt_matrix_to_matrix(want)) <= TOL
    da, db = (T.tt_matrix_to_matrix(port(t)).numpy() for t in (a, b))
    # the core-wise product interleaves the factors' index bits core by core
    dense = np.einsum("abcdef,ghijkl->agbhcidjekfl", da.reshape([2] * 6),
                      db.reshape([2] * 6)).reshape(64, 64)
    assert rel(T.tt_matrix_to_matrix(got).numpy(), dense) <= TOL


@pytest.mark.parametrize("index", [[0, 1, 1], [1, 0, 1], [1, 1, 0]])
def test_entry_matches_jax(index):
    rng = np.random.RandomState(7)
    a = np_train(rng, 3, 2, (2, 2))
    got = T.tt_entry(port(a), index)
    want = J.tt_entry([jnp.asarray(c) for c in a], index)
    tens = T.tt_matrix_to_matrix(port(a)).numpy().reshape([2] * 6)
    assert got == pytest.approx(want, rel=TOL, abs=1e-14)
    assert got == pytest.approx(float(tens[tuple(index) * 2]), rel=TOL, abs=1e-14)


def test_l2_dist_copy_swap_all_match_jax():
    rng = np.random.RandomState(8)
    a, b = np_train(rng, 4, 3, (2, 2)), np_train(rng, 4, 2, (2, 2))
    ja, jb = [jnp.asarray(c) for c in a], [jnp.asarray(c) for c in b]
    da, db = (T.tt_matrix_to_matrix(port(t)).numpy() for t in (a, b))
    got = T.tt_l2_dist(port(a), port(b))
    assert got == pytest.approx(J.tt_l2_dist(ja, jb), rel=1e-10)
    assert got == pytest.approx(np.linalg.norm(da - db), rel=1e-10)

    pa = port(a)
    copy = T.tt_copy(pa)
    assert copy is not pa and all(x is y for x, y in zip(copy, pa))

    swapped = T.tt_swap_all(pa)
    want = J.tt_swap_all(ja)
    assert [tuple(c.shape) for c in swapped] == [tuple(c.shape) for c in want]
    for x, y in zip(swapped, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # reversing the cores reverses the order of the matrix's index bits
    rev = T.tt_matrix_to_matrix(swapped).numpy().reshape([2] * 8)
    assert rel(rev.transpose(3, 2, 1, 0, 7, 6, 5, 4).reshape(16, 16), da) <= TOL


# --- the generator ------------------------------------------------------------

@pytest.mark.parametrize("seed", [256, 493])
@pytest.mark.parametrize("n", [2, 3])
def test_create_problem_matches_jax(n, seed):
    np.random.seed(seed)
    out_j = JG.create_problem(n, 1)
    np.random.seed(seed)
    out_t = TG.create_problem(n, 1, device="cpu")
    assert len(out_t) == len(out_j) == 5
    assert len(out_t[0]) == 2 * n + 1
    dense = n == 2
    for got, want in zip(out_t[:4], out_j[:4]):
        same_train(got, want, dense)
    assert set(out_t[4]) == set(out_j[4]) == {"y", "t"}
    for k in ("y", "t"):
        same_train(out_t[4][k], out_j[4][k], dense)


def test_create_problem_follows_rng():
    """``rng`` draws the instance in place of numpy's global state."""
    np.random.seed(256)
    want = TG.create_problem(2, 1, device="cpu")[0]
    np.random.seed(0)
    got = TG.create_problem(2, 1, device="cpu", rng=np.random.RandomState(256))[0]
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# --- the first Newton system --------------------------------------------------

class _Captured(BaseException):
    """Stops a solve once its first Newton system is built."""


def capture_first_system(ipm_module, problem):
    """The outputs of ``ipm_module.tt_infeasible_newton_system`` at the
    first iteration of the graphm solve of ``problem()``."""
    built = ipm_module.tt_infeasible_newton_system
    out = {}

    def capture(*args):
        out["system"] = built(*args)
        raise _Captured()

    ipm_module.tt_infeasible_newton_system = capture
    try:
        C, L, b, mask, lag = problem()
        lag = {k: ipm_module.tt_reshape(v, (4, 4)) for k, v in lag.items()}
        with pytest.raises(_Captured):
            ipm_module.tt_ipm(lag, ipm_module.tt_reshape(C, (4,)), L,
                              ipm_module.tt_reshape(b, (4,)), ineq_mask=mask,
                              **config_settings())
    finally:
        ipm_module.tt_infeasible_newton_system = built
    return out["system"]


def dense_block_matrix(data, aliases, transposes, to_dense):
    """The block matrix as one dense array (aliases and transposes filled
    in: ``add_alias(src, dst)`` maps the source block ``src`` to ``dst``)."""
    blocks = {k: to_dense(v) for k, v in data.items()}
    for src, dst in aliases.items():
        blocks[tuple(dst)] = blocks[tuple(src)]
    for src, dst in transposes.items():
        blocks[tuple(dst)] = blocks[tuple(src)].T
    n = next(iter(blocks.values())).shape[0]
    size = 1 + max(max(k) for k in blocks)
    out = np.zeros((size * n, size * n))
    for (i, j), blk in blocks.items():
        out[i * n:(i + 1) * n, j * n:(j + 1) * n] = blk
    return out


@pytest.fixture(scope="module")
def first_systems():
    jconfig.set_rank_bucket(1)
    tconfig.set_rank_bucket(1)
    np.random.seed(256)
    sys_j = capture_first_system(jipm, lambda: JG.create_problem(2, 1))
    np.random.seed(256)
    sys_t = capture_first_system(tipm, lambda: TG.create_problem(2, 1, device="cpu"))
    tconfig.set_rank_bucket(4)
    return sys_j, sys_t


def test_first_newton_system_matches_jax(first_systems):
    (lhs_j, rhs_j, st_j), (lhs_t, rhs_t, st_t) = first_systems
    assert set(lhs_t._data) == set(lhs_j._data)
    assert lhs_t._aliases == lhs_j._aliases == {(1, 2): (1, 3)}
    assert lhs_t._transposes == lhs_j._transposes == {(0, 1): (1, 0)}
    for key, block in lhs_j._data.items():
        assert T.tt_ranks(lhs_t._data[key]) == J.tt_ranks(block), key
        assert rel(T.tt_matrix_to_matrix(lhs_t._data[key]).numpy(),
                   J.tt_matrix_to_matrix(block)) <= 1e-10, key
    assert set(rhs_t.keys()) == set(rhs_j.keys()) == {0, 1, 2, 3}
    for row in rhs_j.keys():
        assert rel(T.tt_to_tensor(rhs_t.get_row(row)).numpy(),
                   J.tt_to_tensor(rhs_j.get_row(row))) <= 1e-10, row
    assert st_t.eta == st_j.eta
    assert st_t.mals_rank_restriction == st_j.mals_rank_restriction


def test_first_newton_system_ragged_solve(first_systems, monkeypatch):
    (lhs_j, rhs_j, st_j), _ = first_systems
    data = {k: [np.asarray(c) for c in v] for k, v in lhs_j._data.items()}
    lhs = block_matrix_to_torch(data, lhs_j._aliases, lhs_j._transposes, device="cpu")
    rows = {i: [np.asarray(c) for c in rhs_j.get_row(i)] for i in rhs_j.keys()}
    rhs = block_vector_to_torch(rows, device="cpu")

    calls = []
    local = TK.ipm_local_solver_ineq

    def counted(*args):
        calls.append(args[6].shape[1])
        return local(*args)

    tol = st_j.eta
    # The local solves are many small LAPACK calls: beside the other test
    # workers, more threads than two only contend (10x slower at eight).
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        x, _ = tt_restarted_block_amen(
            lhs, rhs, rank_restriction=st_j.mals_rank_restriction, op_tol=1e-4,
            termination_tol=tol, num_restarts=2, inner_m=st_j.kkt_iterations,
            local_solver=counted, rng=np.random.RandomState(256))
    finally:
        torch.set_num_threads(threads)
    assert calls and set(calls) == {4}  # the four-row inequality system

    A = dense_block_matrix(lhs_j._data, lhs_j._aliases, lhs_j._transposes,
                           lambda t: np.asarray(J.tt_matrix_to_matrix(t)))
    xd = np.concatenate([T.tt_to_tensor(tt_get_block(i, x)).numpy().ravel()
                         for i in range(4)])
    bd = np.concatenate([np.asarray(J.tt_to_tensor(rhs_j.get_row(i))).ravel()
                         for i in range(4)])
    assert np.linalg.norm(A @ xd - bd) <= tol * np.linalg.norm(bd)


# --- end to end ---------------------------------------------------------------

# The settings of the JAX package's own graphm test (tests/test_ipm_e2e.py:206)
E2E_SETTINGS = dict(max_iter=25, gap_tol=5e-4, op_tol=1e-4, abs_tol=1e-3, warm_up=3,
                    aho_direction=False, mals_restarts=2, max_refinement=10, lambdaStar=2.0,
                    lambdaStarIneq=1e-8)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["config", "e2e"])
def test_graphm_n2_matches_jax(which):
    """graphm n=2 seed 256 in both packages (the JAX package's solve takes
    40-50 minutes on a CPU), at configs/graphm_2.yaml's settings and at
    those of tests/test_ipm_e2e.py:206: the same iterations and
    ``ineq_status``, feasibility below 1e-3 in both.

    At the config's settings neither package reaches abs_tol: the Newton
    system of iteration 7 exhausts the fused ladder, the ragged AMEn stalls
    on it (basis-limited) and the finishing phase ends at slackness 1.54e-3
    in both.  There the two solves end alike: the same ranks of X, Y, Z, T
    and slackness within 1%.

    At the e2e test's settings both converge (slackness below 1e-3), with
    the same X ranks, but the ranks of T and the slackness part: JAX T
    [2,6,9,6] at 2.10e-4, the port [2,6,11,6] at 1.96e-4 with torch's
    default threads and [2,6,9,6] at 2.50e-4 with two.  The port's own
    result moves that far with the thread count of its CPU kernels: the
    trajectory follows the last bits of its first ladder solve, whose R=8
    rung stagnates (the first dual step is 7.03e-1 or 6.89e-1 by the thread
    count alone), so these are not compared."""
    from ttipm_tpu.ipm import IneqStatus as IneqJ
    from ttipm_tpu_torch.checks import solve_metrics
    from ttipm_tpu_torch.ipm import IneqStatus

    jconfig.set_rank_bucket(1)
    settings = config_settings() if which == "config" else E2E_SETTINGS

    def run(mod, problem):
        C, L, b, mask, lag = problem()
        lag = {k: mod.tt_reshape(v, (4, 4)) for k, v in lag.items()}
        C, b = mod.tt_reshape(C, (4,)), mod.tt_reshape(b, (4,))
        return (C, L, b), mod.tt_ipm(lag, C, L, b, ineq_mask=mask, **settings)

    np.random.seed(256)
    _, (X_j, _, _, Z_j, info_j) = run(jipm, lambda: JG.create_problem(2, 1))
    np.random.seed(256)
    (C, L, b), (X_t, Y_t, T_t, Z_t, info_t) = run(
        tipm, lambda: TG.create_problem(2, 1, device="cpu"))

    slack_j = abs(J.tt_inner_prod(X_j, Z_j))
    active = info_t["status"].ineq_status is IneqStatus.ACTIVE
    slack, primal, dual = solve_metrics(X_t, Y_t, Z_t, C, L, b, T=T_t, ineq_active=active)
    print(f"graphm n=2 ({which}): iterations {info_j['num_iters']} / {info_t['num_iters']}, "
          f"slackness {slack_j:.4e} / {slack:.4e}, ranks X {info_j['ranksX']} / "
          f"{info_t['ranksX']}, T {info_j['ranksT']} / {info_t['ranksT']}")
    assert info_t["num_iters"] == info_j["num_iters"]
    assert (info_j["status"].ineq_status is IneqJ.ACTIVE) == active
    assert info_t["status"].ineq_status.name == info_j["status"].ineq_status.name
    assert primal < 1e-3 and dual < 1e-3
    assert info_t["ranksX"] == info_j["ranksX"]
    if which == "config":
        assert slack == pytest.approx(slack_j, rel=1e-2)
        for key in ("ranksY", "ranksZ", "ranksT"):
            assert info_t[key] == info_j[key], key
    else:
        assert slack_j < 1e-3 and slack < 1e-3
