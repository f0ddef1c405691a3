"""Acceptance checks shared by ``chip_smoke.py`` and the tests.

``kernel_errors`` holds one kernel call's output against the kernel's
plain PyTorch version on the same operands, and ``check_kernel`` raises
where it is outside these tolerances (float64 operands; float32 below):

- ``schur_assemble`` (K1) and ``kkt_block_matvec`` (K2), and their
  grouped entries ``schur_assemble_group`` and ``kkt_block_product``
  (the blocks of a group stacked): relative Frobenius error <= 1e-12.  On random operands (``cancelling=False``) the
  error is taken relative to the plain result.  The solver's own operands
  can cancel: a block matvec of norm 1e-14 built from terms of norm 1 has
  an f64 rounding error of ~1e-16 in any summation order, cuBLAS's
  included.  With ``cancelling=True`` the error is therefore taken
  relative to the same contraction of the operands' absolute values, the
  scale of the rounding error bound of a sum of products;
- ``panel_qr`` (K3): ||QR - A|| / ||A|| <= 1e-13, ||Q^T Q - I||_max <= 1e-13
  and R exactly zero below the diagonal (Q is not unique for a
  rank-deficient panel, so the factors themselves are compared with the
  plain ones only for the record);
- ``panel_cholesky`` (K4): the same ``info`` as ``torch.linalg.cholesky_ex``
  and, on success, ||L L^T - A|| / ||A|| <= 1e-13;
- ``jacobi_orthogonalise`` (J1) and ``jacobi_eigh_core`` (J2), per
  instance of their batch: NaN exactly in the instances where the plain
  version has NaN; elsewhere, 1e-12 for ||W V_out - W_out|| / ||W||, for
  ||V^T V - I||_max, for the singular values (the square roots of the
  sorted column norms) or eigenvalues against the plain version's relative
  to the largest, and for J1's column cosines max |<wi, wj>| /
  max(|wi| |wj|, 1e-16 max_k |x_k|^2, 1e-30) (the measure of its rotation
  threshold, whose floor leaves columns at the rounding level of the
  operand x alone; the threshold is tol_for(n) <= 1.1e-13), and
  ||V diag(w) V^T - A|| / ||A|| for J2 (J2 without eigenvectors: the
  eigenvalues and the NaN instances alone).  Jacobi's rotations
  are not unique (a rotation skipped near the threshold in one order and
  taken in the other), so the factors are compared with the plain ones
  only through these invariants; ``max_abs_err`` is that of the values.

These are a few hundred ulps of f64 at the solver's sizes; the kernels sum
in another order than cuBLAS / cuSOLVER.

Float32 operands (the f32 instances), by the same rule of a few hundred
ulps (f32's unit roundoff is 6.0e-8): K1 and K2 2e-5 (335 ulps: a sum of
n random products in f32 is off by about u sqrt(n / 2) relative, 2.5e-6
at the 3600-long stage-3 chains of the largest products, and two such
sums in different orders differ by up to twice that); K3's ||QR - A|| /
||A|| and ||Q^T Q - I||_max 1e-5, and K4's ||L L^T - A|| / ||A|| 1e-5
(the backward errors of Householder QR and Cholesky are a small multiple
of u).  The residuals of K3 and K4 are taken in f64 on the upcast factors,
so they measure the kernel's rounding and not that of the check.  An f32
output is held twice: against the plain version in f32 on the same
operands, and (``rel_f64``) against the plain version in f64 on the
operands upcast, with the same bound, so an f32 kernel is held to the
exact product of its operands and not only to another f32 sum.
The batched entries (``schur_assemble_batch``, ``kkt_block_product_batch``,
``panel_qr_batch``, ``panel_cholesky_batch``) are held instance by
instance: instance i of a batched call against the single entry's plain
version on instance i, to that entry's tolerance (``check_batch``).
``solve_metrics`` gives the slackness and feasibility errors by which a
solve counts as converged; ``kkt_residual_norm`` the residual of a fused
KKT solve to the last digits (the solver's own expansion stops at ~1.5e-8
relative).  ``first_newton_system`` captures the IPM's first equilibrated
Newton system of a seeded problem, the batched Newton step's operands.
"""

from __future__ import annotations

import torch

from ttipm_tpu_torch.config import cast_tree, first_dtype, tree_map
from ttipm_tpu_torch.ops import kernels as K
from ttipm_tpu_torch.ops.jacobi import SVD_FLOOR
from ttipm_tpu_torch.ops import tt as tto
from ttipm_tpu_torch.ops.products import tt_fast_matrix_vec_mul
from ttipm_tpu_torch.ops.rounding import tt_rank_reduce, tt_rl_orthogonalise

__all__ = ["TOLERANCE", "TOLERANCE_F32", "PLAIN", "KERNEL_OF", "SINGLE_OF", "tolerance",
           "kernel_errors", "check_kernel", "batch_instance", "batch_errors", "check_batch",
           "shape_key",
           "solve_metrics", "kkt_residual_norm", "first_newton_system"]

TOLERANCE = {"schur_assemble": 1e-12, "kkt_block_matvec": 1e-12,
             "schur_assemble_group": 1e-12, "kkt_block_product": 1e-12,
             "panel_qr": 1e-13, "panel_cholesky": 1e-13,
             "jacobi_orthogonalise": 1e-12, "jacobi_eigh_core": 1e-12}
TOLERANCE_F32 = {"schur_assemble": 2e-5, "kkt_block_matvec": 2e-5,
                 "schur_assemble_group": 2e-5, "kkt_block_product": 2e-5,
                 "panel_qr": 1e-5, "panel_cholesky": 1e-5}


def tolerance(name: str, dtype) -> float:
    """The tolerance of entry point ``name`` for operands of ``dtype``."""
    return (TOLERANCE_F32 if dtype == torch.float32 else TOLERANCE)[name]

PLAIN = {"schur_assemble": K.schur_assemble_plain,
         "kkt_block_matvec": K.kkt_block_matvec_plain,
         "schur_assemble_group": lambda blocks: torch.stack(K.schur_assemble_group_plain(blocks)),
         "kkt_block_product": K.kkt_block_product_plain,
         "panel_qr": K.panel_qr_plain,
         "panel_cholesky": K.panel_cholesky_plain,
         "jacobi_orthogonalise": K.jacobi_orthogonalise_plain,
         "jacobi_eigh_core": K.jacobi_eigh_core_plain}

# The kernel of each entry point (the key of ``kernels.STATS``).
KERNEL_OF = {"schur_assemble": "schur_assemble", "schur_assemble_group": "schur_assemble",
             "kkt_block_matvec": "kkt_block_matvec", "kkt_block_product": "kkt_block_matvec",
             "panel_qr": "panel_qr", "panel_cholesky": "panel_cholesky",
             "jacobi_orthogonalise": "jacobi_svd", "jacobi_eigh_core": "jacobi_eigh"}

# The single entry whose contract an instance of each batched entry keeps.
SINGLE_OF = {"schur_assemble_batch": "schur_assemble_group",
             "kkt_block_product_batch": "kkt_block_product",
             "panel_qr_batch": "panel_qr", "panel_cholesky_batch": "panel_cholesky"}


def _rel(diff: torch.Tensor, ref: torch.Tensor) -> float:
    num, den = float(torch.linalg.norm(diff)), float(torch.linalg.norm(ref))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def _max_abs(t: torch.Tensor) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def _abs(arg):
    """``arg`` with every tensor replaced by its absolute value."""
    return tree_map(torch.abs, arg)


def _contraction_errors(name, args, out, want):
    """max_abs_err, rel and rel_terms of a K1 / K2 output against ``want``
    (the plain version on ``args``), and whether the non-finite entries
    fall where the plain version has them."""
    if name == "schur_assemble_group":
        out = torch.stack(list(out))
    scale = PLAIN[name](*_abs(tuple(args)))
    finite = torch.isfinite(want)
    # A non-finite operand (a candidate the solver then rejects) must give
    # non-finite entries exactly where the plain version has them; the
    # other entries are held to the tolerance.
    same_pattern = bool((torch.isfinite(out) == finite).all())
    zero = torch.zeros_like(want)
    diff = torch.where(finite, out.to(want.dtype) - want, zero)
    errs = {"max_abs_err": _max_abs(diff), "rel": _rel(diff, torch.where(finite, want, zero)),
            "rel_terms": _rel(diff, torch.where(finite, scale, zero))}
    if not bool(finite.all()):
        errs["nonfinite"] = int((~finite).sum())
    return errs, same_pattern


def kernel_errors(name: str, args, out, cancelling: bool = False) -> dict:
    """Errors of ``out = kernels.<name>(*args)`` against the plain version
    on ``args``, with ``"ok"`` false where one exceeds its tolerance (by
    the operands' type).  Calls the plain function directly, so no wrapper
    counter moves."""
    dtype = first_dtype(args)
    tol = tolerance(name, dtype)
    want = PLAIN[name](*args)
    if KERNEL_OF[name] in ("schur_assemble", "kkt_block_matvec"):
        errs, same_pattern = _contraction_errors(name, args, out, want)
        key = "rel_terms" if cancelling else "rel"
        ok = same_pattern and errs[key] <= tol
        if dtype == torch.float32:
            hi_args = cast_tree(tuple(args), torch.float64)
            hi, hi_pattern = _contraction_errors(name, hi_args, out, PLAIN[name](*hi_args))
            errs["rel_f64"] = hi[key]
            ok = ok and hi_pattern and hi[key] <= tol
    elif name == "panel_qr":
        (a,), (q, r), (q0, r0) = args, out, want
        d, d0 = torch.sign(torch.diagonal(r)), torch.sign(torch.diagonal(r0))
        max_abs = max(_max_abs(q * d - q0 * d0), _max_abs(d[:, None] * r - d0[:, None] * r0))
        a, q, r = a.double(), q.double(), r.double()
        eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
        errs = {
            "max_abs_err": max_abs,
            "fact": _rel(q @ r - a, a),
            "orth": _max_abs(q.T @ q - eye),
            "below_diagonal": _max_abs(torch.tril(r, -1)),
        }
        ok = errs["fact"] <= tol and errs["orth"] <= tol and errs["below_diagonal"] == 0.0
    elif name == "panel_cholesky":
        (a,), (L, info), (L0, info0) = args, out, want
        errs = {"info": int(info), "cholesky_ex_info": int(info0)}
        ok = errs["info"] == errs["cholesky_ex_info"]
        if ok and errs["info"] == 0:
            errs["max_abs_err"] = _max_abs(L - L0)
            a, L = a.double(), L.double()
            sym = torch.tril(a) + torch.tril(a, -1).T
            errs["fact"] = _rel(L @ L.T - sym, sym)
            ok = errs["fact"] <= tol
    elif name in ("jacobi_orthogonalise", "jacobi_eigh_core"):
        errs = _jacobi_errors(name, args[0], out, want)
        ok = errs.pop("same_nan") and all(errs[k] <= tol for k in errs if k != "nonfinite")
    else:
        raise KeyError(name)
    errs["ok"] = bool(ok)
    return errs


def _jacobi_errors(name, x, out, want):
    """The invariants of a J1 / J2 output against its plain version, the
    worst over the finite instances (see the module docstring)."""
    bad = ~torch.isfinite(out[0]).reshape(out[0].shape[0], -1).all(dim=1)
    bad_want = ~torch.isfinite(want[0]).reshape(want[0].shape[0], -1).all(dim=1)
    errs = {"same_nan": bool((bad == bad_want).all())}
    if bool(bad_want.any()):
        errs["nonfinite"] = int(bad_want.sum())
    good = ~(bad | bad_want)
    x, out = x[good], [None if t is None else t[good] for t in out]
    want = [t[good] for t in want]
    if out[1] is None:  # J2 without eigenvectors: the values alone
        vals, vals0 = out[0], want[0]
        scale = torch.clamp_min(vals0.abs().amax(dim=1, keepdim=True), 1e-300)
        errs.update({"max_abs_err": _max_abs(vals - vals0),
                     "values": _max_abs((vals - vals0) / scale)})
        return errs
    if name == "jacobi_orthogonalise":
        (w_rot, v, norms2), (_, _, norms2_0) = out[:3], want[:3]
        vals = torch.sqrt(torch.sort(norms2, dim=1).values)
        vals0 = torch.sqrt(torch.sort(norms2_0, dim=1).values)
        fact = _rel_each(x @ v - w_rot, x)
        g = w_rot.mT @ w_rot
        d = torch.diagonal(g, dim1=1, dim2=2)
        floor = SVD_FLOOR * (x * x).sum(1).amax(dim=1)[:, None, None]
        scale = torch.maximum(torch.sqrt(torch.abs(d[:, :, None] * d[:, None, :])), floor)
        cos = torch.abs(g - torch.diag_embed(d)) / torch.clamp_min(scale, 1e-30)
        errs["cosine"] = _max_abs(cos)
    else:
        (vals, v), (vals0, _) = out[:2], want[:2]
        fact = _rel_each(v @ torch.diag_embed(vals) @ v.mT - x, x)
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    scale = torch.clamp_min(vals0.abs().amax(dim=1, keepdim=True), 1e-300)
    errs.update({"max_abs_err": _max_abs(vals - vals0), "values": _max_abs((vals - vals0) / scale),
                 "fact": fact, "orth": _max_abs(v.mT @ v - eye)})
    return errs


def _rel_each(diff, ref) -> float:
    """max over instances of ||diff_i|| / ||ref_i|| (0 for an empty batch)."""
    if diff.shape[0] == 0:
        return 0.0
    num = torch.linalg.norm(diff.reshape(diff.shape[0], -1), dim=1)
    den = torch.linalg.norm(ref.reshape(ref.shape[0], -1), dim=1)
    return float(torch.where(den > 0, num / den, torch.where(num > 0, float("inf"), 0.0)).max())


def shape_key(arg) -> str:
    """The shapes of the tensors in ``arg`` (nested lists and tuples kept,
    other values as they are), as a string."""
    def walk(a):
        if isinstance(a, torch.Tensor):
            return list(a.shape)
        if isinstance(a, (list, tuple)):
            return [walk(x) for x in a]
        return a
    return str(walk(list(arg)))


def batch_instance(name: str, args, kw, out, i: int):
    """Instance ``i`` of a call ``out = kernels.<name>(*args, **kw)`` of a
    batched entry, as a call of its single entry: (single name, args,
    out)."""
    def take(a):
        if isinstance(a, torch.Tensor):
            return a[i]
        if isinstance(a, (list, tuple)):
            return type(a)(take(x) for x in a)
        return a

    single = SINGLE_OF[name]
    if name == "schur_assemble_batch":
        return single, take(tuple(args)), list(out[:, i])
    if name == "panel_qr_batch":
        q, r = out[0][i], out[1][i]
        return single, take(tuple(args)), ((q.T if kw.get("transposed") else q), r)
    return single, take(tuple(args)), take(out)


def batch_errors(name: str, args, out, kw=None, cancelling: bool = False) -> dict:
    """``kernel_errors`` of every instance of a batched call: the worst of
    each error over the instances, K4's ``info`` the first nonzero info of
    an instance (0 where there is none) and ``infos`` the list of them, and
    ``ok`` false where an instance is outside its tolerance."""
    kw = kw or {}
    worst = {"ok": True}
    infos = []
    for i in range(_batch_len(args)):
        single, a, o = batch_instance(name, args, kw, out, i)
        errs = kernel_errors(single, a, o, cancelling)
        worst["ok"] = worst["ok"] and errs["ok"]
        infos.append(errs.get("info"))
        for k, v in errs.items():
            if isinstance(v, float):
                worst[k] = max(worst.get(k, 0.0), v)
    if name == "panel_cholesky_batch":
        worst["info"] = next((int(v) for v in infos if v), 0)
        worst["infos"] = infos
    worst["instances"] = len(infos)
    return worst


def check_batch(name: str, args, out, kw=None, cancelling: bool = False) -> dict:
    """``batch_errors``, raising AssertionError where an instance is
    outside its tolerance."""
    errs = batch_errors(name, args, out, kw, cancelling)
    if not errs["ok"]:
        raise AssertionError(f"{name} {shape_key(args)}: an instance outside its tolerance: "
                             f"{errs}")
    return errs


def _batch_len(args) -> int:
    t = args[0]
    while not isinstance(t, torch.Tensor):
        t = t[0]
    return t.shape[0]


def check_kernel(name: str, args, out, cancelling: bool = False) -> dict:
    """``kernel_errors``, raising AssertionError outside the tolerance."""
    errs = kernel_errors(name, args, out, cancelling)
    if not errs["ok"]:
        tol = tolerance(name, first_dtype(args))
        raise AssertionError(f"{name} {shape_key(args)}: outside tolerance {tol:g}: {errs}")
    return errs


def solve_metrics(X, Y, Z, obj_tt, L_tt, bias_tt, T=None, ineq_active=False):
    """Slackness |<X,Z>| and the squared primal / dual feasibility errors
    ||L vec(X) - b||^2 and ||L^T y - vec(Z + C) [- vec(T)]||^2 of a solve;
    T enters the dual residual where the inequalities are active."""
    slack = abs(tto.tt_inner_prod(X, Z))
    pr = tt_rank_reduce(tto.tt_sub(tt_fast_matrix_vec_mul(L_tt, tto.tt_reshape(X, (4,))),
                                 bias_tt), eps=1e-12)
    dr = tt_rank_reduce(
        tto.tt_sub(
            tt_fast_matrix_vec_mul(tto.tt_transpose(L_tt), tto.tt_reshape(Y, (4,)), eps=1e-12),
            tt_rank_reduce(tto.tt_add(tto.tt_reshape(Z, (4,)), obj_tt), eps=1e-12),
        ),
        eps=1e-12,
    )
    if ineq_active:
        dr = tt_rank_reduce(tto.tt_sub(dr, tto.tt_reshape(T, (4,))), eps=1e-12)
    return slack, tto.tt_inner_prod(pr, pr), tto.tt_inner_prod(dr, dr)


def kkt_residual_norm(A, b, x_cores, ineq=False) -> float:
    """||b - K x|| of a fused KKT solve's solution ``x_cores`` (``A`` and
    ``b`` as ``solvers/fused.py``'s ``prep_operator`` / ``prep_rhs`` give
    them).  Each row's residual is formed as an exact train (b_i minus the
    row's terms A_key x_col, concatenated) and RL-orthogonalised; its norm
    is that of the first core.  The orthogonalisation's rounding is
    relative to the trains' scale, so relative residuals resolve to about
    1e-15, where ``fused_residual_norm``'s expansion
    ||b||^2 - 2 <b, Kx> + ||Kx||^2 cancels below ~1.5e-8."""
    from ttipm_tpu_torch.solvers import fused_algebra as fa

    block_pos = max(range(len(x_cores)), key=lambda i: x_cores[i].dim())
    x_cols = []
    for j in range(fa.nrows(ineq)):
        cols = list(x_cores)
        cols[block_pos] = x_cores[block_pos][:, j]
        x_cols.append(cols)
    total = 0.0
    for i, terms in enumerate(fa.row_terms(ineq)):
        train = list(b[i])
        for key, col, transpose in terms:
            train = tto.tt_sub(train, fa.virtual_term_cores(A, x_cols, key, col, transpose))
        total += float(torch.sum(tt_rl_orthogonalise(train)[0].double() ** 2))
    return float(total ** 0.5)


class _Captured(BaseException):
    """Stops a solve at its first KKT solve (the IPM's Newton step turns an
    ``Exception`` into a zero step)."""


def first_newton_system(problem: str, config: dict, seed: int, device):
    """The first Newton system of ``problem`` at seed ``seed`` and the
    settings of ``config`` (a runner config), as ``ipm.tt_ipm`` builds and
    equilibrates it when the runner solves that seed: ``(lhs, rhs, X, Z)``,
    captured at its first KKT solve, with the iterates it was built at.
    One instance's arguments of ``parallel.fused_mesh.tt_newton_step_batch``."""
    from ttipm_tpu_torch import ipm
    from ttipm_tpu_torch.utils import runner

    build, solve, seen = ipm.tt_infeasible_newton_system, ipm._solve_kkt, {}

    def build_seen(lhs, obj, X, Y, Z, *rest):
        seen["X"], seen["Z"] = X, Z
        return build(lhs, obj, X, Y, Z, *rest)

    def solve_seen(solver, lhs, rhs, status):
        seen["system"] = (lhs, rhs)
        raise _Captured

    lag_maps, obj, L, bias, mask = runner.seeded_problem(
        runner.load_problem(problem), config["dim"], 1, seed, device)
    ipm.tt_infeasible_newton_system, ipm._solve_kkt = build_seen, solve_seen
    try:
        ipm.tt_ipm(lag_maps, obj, L, bias, ineq_mask=mask,
                   **{**runner.ipm_kwargs(config), "verbose": False})
    except _Captured:
        pass
    finally:
        ipm.tt_infeasible_newton_system, ipm._solve_kkt = build, solve
    if "system" not in seen:
        raise RuntimeError(f"{problem} seed {seed}: the solve ended before its first KKT solve")
    return (*seen["system"], seen["X"], seen["Z"])
