"""The finishing sweep of the whole-solve eigen programs, held to the host
loops' rule.

The JAX package's host loops (``_tt_max_generalised_eigen_fused_impl``,
``_tt_min_eig_fused_impl``) finish in the direction opposite the last half
sweep they took: backward after a forward half, forward after a backward
half whose residuals were already below ``tol`` (a pair that skipped its
forward half), and not at all after a zero step or a stall above ``tol``.
The JAX programs always finish backward.  The port's programs
(``solvers/fused_eigen_batch.py``) follow the host loops: a documented
deviation from the JAX programs.

The skipping pencil is one of maxcut d8 seed 24's warm-started step-size
pencils (``python -m tests.test_torch_whole_solve_e2e --dim 8 --seed 24
--whole on --pencils`` at ``OMP_NUM_THREADS=3``: both packages' programs
gave 0.3832 there, the exact step and the host loops 1.0), saved in
``tests/data/whole_finish_d8_seed24_pencil.npz`` (the trains A, Delta and
the warm start x0).  The smallest-eigenvector program skips its forward
half when warm-started at its own converged vector.  Tolerances are
stated at each check.  The programs' tiny ops run on one thread (torch's
and the BLAS's), as tests/test_torch_jacobi.py runs the plain Jacobi:
with a thread pool each under xdist they crawl.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from ttipm_tpu import config as jconfig
from ttipm_tpu.solvers import fused_eigen as FE
from ttipm_tpu_torch import config as tconfig
from ttipm_tpu_torch.solvers import fused_eigen as TE
from ttipm_tpu_torch.solvers import fused_eigen_batch as feb
from ttipm_tpu_torch.solvers.fused_batch import batch_of_one

from test_torch_whole_solve import _overlap, _pencil, _port
from test_torch_whole_solve_e2e import _dense as _matrix
from test_torch_whole_solve_e2e import _exact_step

PENCIL = os.path.join(os.path.dirname(__file__), "data", "whole_finish_d8_seed24_pencil.npz")
TOL = 1e-8


@pytest.fixture(autouse=True)
def _switch_restored():
    tconfig.set_rank_bucket(1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)
    jconfig.set_fused_whole_solve(None)
    tconfig.set_fused_whole_solve(None)
    tconfig.set_rank_bucket(4)


@pytest.fixture(scope="module")
def skipping_pencil():
    z = np.load(PENCIL)
    return tuple([z[f"{name}{k}"] for k in range(8)] for name in ("A", "D", "x0"))


def _torch(train):
    return [torch.as_tensor(c) for c in train]


def _jax(train):
    return [jnp.asarray(c) for c in train]


def _gen_args(A, D, x0, seed=0):
    """The generalised program's operands as ``tt_max_generalised_eigen_fused``
    prepares them (batch of one, nine pairs at most)."""
    A_p, D_p = TE._prep_operator(A), TE._prep_operator(D)
    d, n = len(A), A[0].shape[1]
    caps = TE._vec_caps(d, 8, n)
    xs = TE._prep_vec(x0, d, n, caps, np.random.RandomState(seed), A_p[0])
    return (batch_of_one(A_p), batch_of_one(D_p), batch_of_one(xs),
            torch.ones(1, dtype=torch.float64), TOL, caps, 9)


def _gen(flag, A, D, x0):
    tconfig.set_fused_whole_solve(flag)
    return TE.tt_max_generalised_eigen_fused(_torch(A), _torch(D), x0=_torch(x0), tol=TOL)


def test_skipping_pencil_finishes_forward_as_the_host_loop(skipping_pencil):
    A, D, x0 = skipping_pencil
    *_, direction = feb.gen_eigen_single(*_gen_args(_torch(A), _torch(D), _torch(x0)))
    assert direction.tolist() == [1]  # the last pair skipped its forward half
    s_prog, v_prog = _gen(True, A, D, x0)
    s_loop, v_loop = _gen(False, A, D, x0)
    jconfig.set_fused_whole_solve(False)
    s_jax, v_jax = FE.tt_max_generalised_eigen_fused(_jax(A), _jax(D), x0=_jax(x0), tol=TOL)
    exact = _exact_step(_matrix(A), _matrix(D))
    # the port's eager loop: the step to 1e-10 relative, the eigenvector's
    # overlap 1 to 1e-10
    assert s_prog == pytest.approx(s_loop, rel=1e-10)
    assert _overlap(v_loop, v_prog) == pytest.approx(1.0, abs=1e-10)
    # the JAX host loop: the same, to 1e-10 and 1e-8
    assert s_prog == pytest.approx(float(s_jax), rel=1e-10)
    assert _overlap(v_jax, v_prog) == pytest.approx(1.0, abs=1e-8)
    # the dense pencil's exact step, to 1e-6 relative (here the cap, 1)
    assert s_prog == pytest.approx(exact, rel=1e-6)
    assert exact == 1.0


def test_a_backward_finisher_after_the_skipped_half_misses_the_step(skipping_pencil):
    """The fault the rule repairs: from the carry the loop ends with, the
    backward finisher (the JAX program's) gives 0.3832, the forward one
    the exact step; the JAX program still gives the former."""
    A, D, x0 = skipping_pencil
    A_b, D_b, xs, alpha0, tol, caps, max_pairs = _gen_args(_torch(A), _torch(D), _torch(x0))
    carry = feb._gen_start(A_b, D_b, xs, alpha0, tol, caps, selects=True)
    for _ in range(max_pairs):
        if not bool(feb._gen_active(carry, tol)[0]):
            break
        carry = feb._gen_pair(A_b, D_b, carry, tol, caps, selects=True)
    assert carry[-1].tolist() == [False]  # the last half sweep taken ran backward
    alpha = {bwd: float(feb._finish_sweep(A_b, D_b, carry[0], carry[1], tol, caps, bwd)[1][0])
             for bwd in (True, False)}
    assert alpha[True] == pytest.approx(0.3832, abs=1e-4)
    assert alpha[False] == pytest.approx(1.0, rel=1e-10)
    jconfig.set_fused_whole_solve(True)
    s_jax_program, _ = FE.tt_max_generalised_eigen_fused(_jax(A), _jax(D), x0=_jax(x0), tol=TOL)
    # the JAX program's step is the backward finisher's, to 1e-6 relative
    assert float(s_jax_program) == pytest.approx(alpha[True], rel=1e-6)


@pytest.mark.parametrize("d,seed", [(3, 0), (4, 1), (5, 2)])
def test_parity_pencils_finish_backward(d, seed):
    """tests/test_torch_whole_solve.py holds these pencils to the JAX
    program: none of them skips a forward half, so both rules finish
    backward there."""
    A, D = _pencil(d, seed)
    np.random.seed(7)
    *_, direction = feb.gen_eigen_single(*_gen_args(_port(A), _port(D), None, seed=7))
    assert direction.tolist() == [-1]


def test_single_program_is_the_batch_programs_instance_after_a_skip(skipping_pencil):
    """gen_eigen_single (selects) and gen_eigen_program (branching) on the
    skipping pencil: the same bits on the CPU, the direction included."""
    args = _gen_args(*(_torch(t) for t in skipping_pencil))
    single = feb.gen_eigen_single(*args)
    batch = feb.gen_eigen_program(*args)
    assert all(torch.equal(a, b) for a, b in zip(single[0], batch[0]))
    for a, b in zip(single[1:], batch[1:]):
        assert torch.equal(a, b)


def test_batch_takes_each_instance_s_direction(skipping_pencil):
    """A batch of two instances of the skipping pencil, the saved warm start
    (forward finish) and a fresh start (backward finish): each instance's
    step and cores are its batch of one's, to 1e-12 relative."""
    A, D, x0 = (_torch(t) for t in skipping_pencil)
    warm = _gen_args(A, D, x0)
    fresh = _gen_args(A, D, None, seed=3)
    both = tuple([torch.cat([a, b]) for a, b in zip(w, f)] for w, f in zip(warm[:3], fresh[:3]))
    both += (torch.ones(2, dtype=torch.float64),) + warm[4:]
    xs, alpha, _, _, direction = feb.gen_eigen_program(*both)
    assert direction.tolist() == [1, -1]
    for i, args in enumerate((warm, fresh)):
        xs1, alpha1, _, _, dir1 = feb.gen_eigen_program(*args)
        assert dir1.tolist() == [direction.tolist()[i]]
        assert float(alpha[i]) == pytest.approx(float(alpha1[0]), rel=1e-12)
        for a, b in zip(xs, xs1):
            assert float((a[i] - b[0]).abs().max()) <= 1e-12 * float(b[0].abs().max())


def _min_args(A, x0, seed=7):
    A_p = TE._prep_operator(A)
    d, n = len(A), A[0].shape[1]
    caps = TE._vec_caps(d, 8, n)
    xs = TE._prep_vec(x0, d, n, caps, np.random.RandomState(seed), A_p[0])
    return batch_of_one(A_p), batch_of_one(xs), TOL, caps, 9


@pytest.mark.parametrize("d,seed", [(3, 0), (5, 2)])
def test_min_program_finishes_forward_after_a_skipped_half(d, seed):
    """Warm-started at its own converged vector, the smallest-eigenvector
    program skips the forward half of its first pair and finishes forward,
    as tt_min_eig_fused's host loop does (``finish(+1)``)."""
    A, _ = _pencil(d, seed)
    A_t = _port(A)
    xs, _, direction = feb.min_eig_program(*_min_args(A_t, None))
    assert direction.tolist() == [-1]
    x0 = [c[0] for c in xs]
    xs_warm, _, direction = feb.min_eig_program(*_min_args(A_t, x0))
    assert direction.tolist() == [1]
    tconfig.set_fused_whole_solve(True)
    x_prog, v_prog = TE.tt_min_eig_fused(A_t, x0=x0, return_eig_val=True)
    tconfig.set_fused_whole_solve(False)
    x_loop, v_loop = TE.tt_min_eig_fused(A_t, x0=x0, return_eig_val=True)
    jconfig.set_fused_whole_solve(False)
    x_jax, v_jax = FE.tt_min_eig_fused(A, x0=[jnp.asarray(c.numpy()) for c in x0],
                                       return_eig_val=True)
    M = _matrix([np.asarray(c) for c in A])
    lam = np.linalg.eigvalsh(0.5 * (M + M.T))[0]
    # the eigenvalue: 1e-10 relative to the port's eager loop and the JAX
    # host loop, 1e-4 to the dense one; the eigenvector: overlap 1 to 1e-8
    assert float(v_prog) == pytest.approx(float(v_loop), rel=1e-10)
    assert float(v_prog) == pytest.approx(float(v_jax), rel=1e-10)
    assert float(v_prog) == pytest.approx(lam, rel=1e-4, abs=1e-7)
    assert _overlap(x_loop, x_prog) == pytest.approx(1.0, abs=1e-8)
    assert _overlap(x_jax, x_prog) == pytest.approx(1.0, abs=1e-8)


# last half forward, sweep residual, stalled, alpha finite and positive -> direction
FINISH_CASES = [
    (True, 1e-12, False, True, -1),   # converged after a forward half: backward
    (False, 1e-12, False, True, 1),   # converged after a backward half (skipped): forward
    (True, 1e-6, True, True, 0),      # stalled above tol: the host loop breaks unfinished
    (True, 1e-12, True, True, -1),    # stalled below tol: converged first, finished
    (True, 1e-6, False, True, -1),    # out of pairs: finished after the last half
    (True, 1e-12, False, False, 0),   # a zero or non-finite step: unfinished
]


@pytest.mark.parametrize("fwd,res,stalled,ok,want", FINISH_CASES)
def test_finish_masks(fwd, res, stalled, ok, want):
    t = torch.tensor
    bwd_m, fwd_m, direction = feb._finish_masks(t([fwd]), t([res]), t([stalled]), TOL, t([ok]))
    assert direction.tolist() == [want]
    assert bwd_m.tolist() == [want == -1] and fwd_m.tolist() == [want == 1]


def test_stalled_end_keeps_the_cores(skipping_pencil):
    """A carry that stopped on a stall above tol leaves the finishing step
    with its cores and alpha as they are, in both programs' ends."""
    A, D, x0 = (_torch(t) for t in skipping_pencil)
    A_b, D_b, xs, alpha0, tol, caps, _ = _gen_args(A, D, x0)
    carry = list(feb._gen_start(A_b, D_b, xs, alpha0, tol, caps, selects=True))
    carry[3] = torch.tensor([1e-6], dtype=torch.float64)  # the sweep residual, above tol
    carry[6] = torch.tensor([True])                       # stalled
    out, alpha, _, _, direction = feb._gen_end(A_b, D_b, tuple(carry), tol, caps)
    assert direction.tolist() == [0]
    assert torch.equal(alpha, carry[1])
    assert all(torch.equal(a, b) for a, b in zip(out, carry[0][0]))
    A_m, xs_m, _, caps_m, _ = _min_args(A, x0)
    m_carry, _ = feb._min_start(A_m, xs_m, tol, caps_m)
    m_carry = list(m_carry)
    m_carry[2] = torch.tensor([1e-6], dtype=torch.float64)
    m_carry[4] = torch.tensor([True])
    out, direction = feb._min_end(A_m, tuple(m_carry), tol, caps_m)
    assert direction.tolist() == [0]
    assert all(torch.equal(a, b) for a, b in zip(out, m_carry[0][0]))
