"""The port's reporting (``ttipm_tpu_torch.utils.reporting``) against the
JAX package's on the same results-JSON files: files written by the port's
runner (``save_results_summary``, the JAX runner's schema) for several
dims and ranks give the same LaTeX rows, heatmap grid, scatter data and
CLI output in both packages; ``format_scientific`` agrees on the edge
cases."""

import argparse
import json

import numpy as np
import pytest

from ttipm_tpu.utils import reporting as JR
from ttipm_tpu_torch.utils import reporting as TR
from ttipm_tpu_torch.utils.runner import new_record, save_results_summary


@pytest.fixture
def results_dir(tmp_path):
    """maxcut results at d3-d5 and ranks 1-2, and a corr_clust file that the
    maxcut readers must not pick up."""
    rng = np.random.RandomState(0)
    for problem, dim, rank in [("maxcut", 3, 1), ("maxcut", 4, 1), ("maxcut", 5, 1),
                               ("maxcut", 4, 2), ("corr_clust", 3, 1)]:
        rec = new_record(3, dim - 1)
        for key in ("runtimes", "problem_creation_times", "feasibility_errors",
                    "dual_feasibility_errors", "complementary_slackness", "memory"):
            rec[key] = 10.0 ** rng.uniform(-6, 2, size=3)
        rec["num_iters"] = rng.randint(5, 20, size=3).astype(float)
        rec["ranksX"] = rng.randint(1, 9, size=(3, dim - 1)).astype(float)
        args = argparse.Namespace(config=f"configs/{problem}_{dim}.yaml", track_mem=True,
                                  rank=rank)
        save_results_summary({"dim": dim, "seeds": [1, 2, 3]}, args, rec,
                             filename=str(tmp_path / f"{problem}_{dim}_trackmem_True_seeds_"
                                                     f"1-2-3_ranks_{rank}.json"))
    return str(tmp_path)


def test_latex_table_matches_jax(results_dir):
    got = TR.results_to_latex_table("maxcut", results_dir)
    assert got == JR.results_to_latex_table("maxcut", results_dir)
    assert got.count("\\\\") == 1 + 4  # the header and one row a file


@pytest.mark.parametrize("dims", [None, (4, 5)])
def test_heatmap_and_scatter_match_jax(results_dir, dims):
    assert TR.collect_heatmap_data("maxcut", dims, results_dir) == \
        JR.collect_heatmap_data("maxcut", dims, results_dir)
    assert TR.collect_scatter_data("maxcut", dims, results_dir) == \
        JR.collect_scatter_data("maxcut", dims, results_dir)


def test_row_stats_and_formatting_match_jax(results_dir):
    import glob

    for fp in glob.glob(results_dir + "/*.json"):
        data = json.load(open(fp))
        assert TR.result_row_stats(data) == JR.result_row_stats(data)
    for m, s in [(0, 0), (0, 3e-4), (1.5, 0.25), (-2.5e-7, 1e-8), (123.4, 0.0)]:
        assert TR.format_scientific(m, s) == JR.format_scientific(m, s)


@pytest.mark.parametrize("mode", ["table", "heatmap", "scatter"])
def test_cli_matches_jax(results_dir, mode, capsys):
    argv = [mode, "maxcut", "--results_dir", results_dir]
    TR.main(argv)
    got = capsys.readouterr().out
    JR.main(argv)
    assert got == capsys.readouterr().out
