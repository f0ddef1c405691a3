"""The benchmark's frozen copy of the instance generators gives the
program's instances, and hands them to the program as the same matrices."""

import numpy as np
import pytest
import torch

from portbench import program
from portbench.families import corr_clust as cc_family
from portbench.families import maxcut as mc_family
from portbench.reference.tt import dense_matrix, matrix_train, round_train
from ttipm_tpu_torch.models import corr_clust, maxcut
from ttipm_tpu_torch.ops.tt import tt_matrix_to_matrix, tt_reshape

# (dim, seed) where the program's sampler takes a graph with edges; where it
# takes an empty one the two differ by design (reference/graph.py)
MAXCUT = [(3, 0), (3, 7), (3, 319), (3, 764), (4, 0), (4, 7), (4, 319), (4, 764)]
CORR_CLUST = [(3, 0), (3, 7), (3, 764), (4, 0), (4, 7), (4, 319), (4, 764)]


def test_the_solve_goes_on_with_the_runners_stream():
    """An instance's solve starts from numpy's stream where the program's
    runner leaves it after drawing the instance."""
    from ttipm_tpu_torch.utils.runner import seeded_problem

    seeded_problem(maxcut.create_problem, 4, 1, 319, torch.device("cpu"))
    expected = np.random.random(4)
    inst = program.instance(mc_family, {"dim": 4, "graph_rank": 1}, 319,
                            torch.device("cpu"), torch.float64)
    np.testing.assert_array_equal(inst.rng().random_sample(4), expected)


def _dense(train):
    return tt_matrix_to_matrix(tt_reshape(train, (2, 2))).numpy()


@pytest.mark.parametrize("dim,seed", MAXCUT)
def test_maxcut_copy_gives_the_programs_instance(dim, seed):
    p = mc_family.problem({"dim": dim, "graph_rank": 1}, np.random.RandomState(seed))
    obj, _, bias, _ = maxcut.create_problem(dim, 1, device="cpu",
                                            rng=np.random.RandomState(seed))
    np.testing.assert_allclose(p.C, _dense(obj), atol=1e-12)
    np.testing.assert_allclose(p.B, _dense(bias), atol=1e-12)


@pytest.mark.parametrize("dim,seed", CORR_CLUST)
def test_corr_clust_copy_gives_the_programs_instance(dim, seed):
    p = cc_family.problem({"dim": dim, "graph_rank": 1, "ineq_beta": 0.01},
                          np.random.RandomState(seed))
    obj, _, bias, mask, lags = corr_clust.create_problem(dim, 1, device="cpu",
                                                         rng=np.random.RandomState(seed))
    np.testing.assert_allclose(p.C, _dense(obj), atol=1e-9)
    np.testing.assert_allclose(p.ineq_mask, tt_matrix_to_matrix(mask).numpy(), atol=1e-9)
    np.testing.assert_allclose(1.0 - p.ineq_mask, p.lag["t"])


@pytest.mark.parametrize("family,dim,seed", [("maxcut", 4, 7), ("corr_clust", 4, 319)])
def test_the_program_gets_the_references_matrices(family, dim, seed):
    mod = mc_family if family == "maxcut" else cc_family
    p = mod.problem({"dim": dim, "graph_rank": 1, "ineq_beta": 0.01}, np.random.RandomState(seed))
    args = program.port_problem(p, torch.device("cpu"), torch.float64)
    np.testing.assert_allclose(_dense(args["obj_tt"]), p.C, atol=1e-13)
    np.testing.assert_allclose(_dense(args["bias_tt"]), p.B, atol=1e-13)
    for key, cores in list(args["lag_maps"].items()) + [("eq", args["lin_op_tt"])]:
        mask = p.eq_mask if key == "eq" else p.lag[key]
        diag = [torch.diagonal(c, dim1=1, dim2=2).permute(0, 2, 1) for c in cores]
        np.testing.assert_allclose(_dense(diag), mask, atol=1e-13)
    assert all(c.dim() == 3 for c in args["obj_tt"])
    assert all(c.dim() == 4 and c.shape[1:3] == (4, 4) for c in args["lin_op_tt"])


def test_trains_round_trip_and_round():
    rng = np.random.RandomState(3)
    m = rng.randn(16, 16)
    cores = matrix_train(m)
    np.testing.assert_allclose(dense_matrix(cores), m, atol=1e-12)
    rounded = round_train(cores + [], 1e-12)
    np.testing.assert_allclose(dense_matrix(rounded), m, atol=1e-12)
    low = np.kron(np.kron(rng.randn(2, 2), rng.randn(2, 2)), np.kron(rng.randn(2, 2),
                                                                    rng.randn(2, 2)))
    assert [c.shape[-1] for c in round_train(matrix_train(low), 1e-12)[:-1]] == [1, 1, 1]
