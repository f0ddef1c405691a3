"""What each rank of a spawned mesh runs for tests/test_torch_mesh.py.

A module of its own, importing neither JAX nor the JAX package, since the
spawned ranks import it: each function runs the port's mesh solvers on
the inputs the test built and returns numpy data.  Where the mesh has one
kkt column (seeds only), rank 0 also runs ``mesh=None`` on the same
inputs in the same process (the same threads), for the bit comparison.
"""

import numpy as np
import torch

from ttipm_tpu_torch import config
from ttipm_tpu_torch.ops.tt import tt_add, tt_scale
from ttipm_tpu_torch.parallel import fused_mesh as M
from ttipm_tpu_torch.parallel.mesh import batched_solve_metrics, sharded_newton_micro


def _np(tt):
    return [c.detach().cpu().numpy() for c in tt]


def _newton(mesh, systems, Xs, Zs, eta=None):
    xs, zs, dirs = M.tt_newton_step_batch(systems, Xs, Zs, mesh=mesh, R=12, seed=5)
    out = {"x": xs, "z": zs, "dirs": [[_np(t) for t in d] for d in dirs]}
    if eta is not None:  # the PSD-rounded next iterates (tests/test_parallel.py:246)
        from ttipm_tpu_torch.ops.rounding import tt_psd_rank_reduce

        out["next"] = [[_np(tt_psd_rank_reduce(tt_add(base, tt_scale(float(step), d[which])),
                                               eps=e))
                        for base, step, which in ((Xs[i], xs[i], 1), (Zs[i], zs[i], 2))]
                       for i, (d, e) in enumerate(zip(dirs, eta))]
    return out


def run_all(mesh, data):
    """Every case on this rank's mesh; ``data`` holds the inputs (torch
    CPU tensors and port trains / block systems) built by the test."""
    config.set_rank_bucket(1)
    out = {"mesh": dict(mesh.shape)}
    step = sharded_newton_micro(mesh)
    xs, mean = step(*data["micro"])
    out["micro"] = (xs.numpy(), float(mean))
    out["metrics"] = float(batched_solve_metrics(mesh, data["errs"]))

    def cases(m):
        res = {}
        kw = dict(R=16, ineq=False, term_tol=1e-10, nswp=14, seed=7)
        x, r = M.tt_block_amen_fused_batch(*data["fused"], mesh=m, **kw)
        res["fused"] = ([_np(t) for t in x], r)
        np.random.seed(7)
        steps, warm = M.tt_step_sizes_batch(data["pencils"], mesh=m)
        res["steps"] = (steps, [_np(w) for w in warm])
        res["newton"] = _newton(m, *data["newton"])
        res["full"] = _newton(m, *data["full"], eta=data["eta"])
        return res

    out["cases"] = cases(mesh)
    out["stats"] = mesh.stats.as_dict()
    if mesh.kkt == 1 and mesh.rank == 0:
        out["cases_no_mesh"] = cases(None)
    return out
