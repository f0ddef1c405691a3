"""The randomised TT tools of the port (``ttipm_tpu_torch.ops.randomized``)
against the JAX package's, on the cases of tests/test_randomized.py: the
same numpy seed gives both packages the same Gaussian trains, so the
partial contractions agree to 1e-12 relative, and the sketched
orthogonalisations and the generalised Nystrom reduction recover a train
exactly when the target ranks dominate its ranks (1e-8 / 1e-7, the JAX
test's bounds) and agree with the JAX package's results to the same
bounds."""

import numpy as np
import pytest
import torch

from ttipm_tpu.ops import randomized as JR
from ttipm_tpu.ops.random import tt_random_gaussian as gauss_j
from ttipm_tpu.ops.tt import tt_inner_prod as inner_j
from ttipm_tpu.ops.tt import tt_matrix_to_matrix as dense_j
from ttipm_tpu_torch.interop import tt_to_numpy, tt_to_torch
from ttipm_tpu_torch.ops import randomized as TR
from ttipm_tpu_torch.ops.tt import tt_matrix_to_matrix as dense_t


def _pair(seed, ranks, d=4):
    np.random.seed(seed)
    A = gauss_j([ranks] * (d - 1), (2, 2))
    return A, tt_to_torch(A, device="cpu")


@pytest.mark.parametrize("which", ["rl", "lr"])
def test_partial_contractions_match_jax(which):
    A_j, A_t = _pair(0, 2)
    B_j, B_t = _pair(1, 3)
    fn_j = JR.tt_rl_contraction if which == "rl" else JR.tt_lr_contraction
    fn_t = TR.tt_rl_contraction if which == "rl" else TR.tt_lr_contraction
    got, want = fn_t(A_t, B_t), fn_j(A_j, B_j)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max()
    if which == "rl":  # the full contraction through the first cores is <A, B>
        full = torch.einsum("aijb,cijd->bd", A_t[0], B_t[0])
        assert abs(float(torch.sum(full * got[0])) - inner_j(A_j, B_j)) < 1e-10


@pytest.mark.parametrize("name,tol", [("tt_lr_random_orthogonalise", 1e-8),
                                      ("tt_rl_random_orthogonalise", 1e-8),
                                      ("tt_generalised_nystroem", 1e-7)])
def test_sketched_reductions_recover_and_match_jax(name, tol):
    A_j, A_t = _pair(2, 2)
    Ad = np.asarray(dense_j(A_j))
    np.random.seed(9)
    out_j = getattr(JR, name)(list(A_j), [3] * 3)
    np.random.seed(9)
    out_t = getattr(TR, name)(list(A_t), [3] * 3)
    got = dense_t(out_t).numpy()
    np.testing.assert_allclose(got, Ad, atol=tol)
    np.testing.assert_allclose(got, np.asarray(dense_j(out_j)), atol=tol)
    assert [c.shape for c in tt_to_numpy(out_t)] == [np.asarray(c).shape for c in out_j]


def test_sketches_draw_the_jax_sketch():
    A_j, A_t = _pair(3, 2)
    np.random.seed(4)
    s_j = JR.tt_sketch((2, 2), [1, 3, 3, 1])
    l_j = JR.tt_sketch_like(A_j, [1, 2, 5, 2, 1])
    np.random.seed(4)
    s_t = TR.tt_sketch((2, 2), [1, 3, 3, 1], device="cpu")
    l_t = TR.tt_sketch_like(A_t, [1, 2, 5, 2, 1])
    for got, want in zip(s_t + l_t, s_j + l_j):
        assert np.array_equal(got.numpy(), np.asarray(want))
